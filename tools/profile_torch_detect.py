#!/usr/bin/env python3
"""Where the time of one loop-detection sub-batch goes, on a CUDA GPU.

    python3 tools/profile_torch_detect.py [--out DIR]

Renders the two-robot clip with the PyTorch port (coxgraph_tpu_torch),
fills the endurance run's detector (eval.benchmarks.detector_config) with
robot 0's keyframes, warms one of robot 1's 8-frame sub-batches on a copy
of that state, then traces robot 1's sub-batch (detection, Hamming scoring
of the 512-slot pool, RANSAC verification, the one result read, the
append) with torch.profiler (CPU and CUDA activities). Prints the
sub-batch's wall time, the summed device time of its kernels, the device
busy share (summed device-side event time / wall time; one stream, so
events do not overlap), kernel launches, and the kernels and host
operations that take the most time. With --out, writes the Chrome trace
there. Fails when no CUDA GPU is present.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import print_top, profiled  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace")
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.frontends import loop_detector as ld

    device = runtime.require_cuda()
    print(runtime.gpu_identity())
    cfg = bm.detector_config()
    intr, _, frames = bm.two_robot_clip(device)
    items = [[(r, (100.0 if r else 0.0) + bm.KF_DT * i, c, d)
              for i, (d, c) in enumerate(frames[r])] for r in (0, 1)]
    batch = items[1][:cfg.batch_size]

    def robot0_detector():
        det = ld.LoopDetector(intr, cfg, device=device)
        det.add_keyframes_batch(items[0])
        return det

    robot0_detector().add_keyframes_batch(batch)          # warm-up
    det = robot0_detector()
    msgs = []
    wall_ms, dev_ms, launches, events, kernels, prof = profiled(
        lambda: msgs.extend(det.add_keyframes_batch(batch)))
    print(f"sub-batch of {len(batch)} frames ({intr.width}x{intr.height}, "
          f"K = {cfg.features.max_keypoints}, {cfg.max_keyframes} slots): "
          f"wall {wall_ms:.3f} ms, device time {dev_ms:.3f} ms, device "
          f"busy share {dev_ms / wall_ms:.3f}, kernel launches {launches}, "
          f"messages {len(msgs)}")
    print_top(events, kernels, 15)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out,
                                              "detect_sub_batch.json"))


if __name__ == "__main__":
    main()
