#!/usr/bin/env python3
"""Where the time of one integrate_batch window goes, on a CUDA GPU, and
the allocation pass timed alone.

    python3 tools/profile_torch_integrate.py [--frames 30] [--out DIR]

Renders the bench clip with the PyTorch port (coxgraph_tpu_torch), warms
one window at the bench operating point, then traces one 30-frame window
with torch.profiler (CPU and CUDA activities). Prints the window's wall
time, the summed device time of its kernels, the device busy share
(summed device-side event time / wall time; one stream, so events do
not overlap),
and the kernels and host operations that take the most time. With --out,
writes the Chrome trace there.

Then the allocation pass alone at client_vga's shapes over the same
clip, as ``chip_smoke.py`` phase 6 runs it (``alloc_pass_record``: the
two kernels ≡ the plain version on every frame, then both timed on a
steady frame beside the bytes' bound), as one JSON line
(``"alloc_pass"``). Fails when no CUDA GPU is present.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from chip_smoke import alloc_pass_record, print_top, profiled  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace")
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.mapper import submap_mapper as sm

    device = runtime.require_cuda()
    print(runtime.gpu_identity())
    cfg = bm._mapper_config()
    depths, colors, traj = bm.generate_frames(device, args.frames)
    ts = torch.arange(args.frames, dtype=torch.float32, device=device) * 0.05
    state = sm.create_mapper(cfg, device)
    sm.start_submap(cfg, state, traj[0], ts[0])
    sm.integrate_batch(cfg, state, depths, colors, traj, ts)   # warm-up
    wall_ms, dev_ms, launches, events, kernels, prof = profiled(
        lambda: sm.integrate_batch(cfg, state, depths, colors, traj, ts))
    print(f"window of {args.frames} frames: wall {wall_ms:.3f} ms "
          f"({wall_ms / args.frames:.4f} ms/frame), device time "
          f"{dev_ms:.3f} ms, device busy share {dev_ms / wall_ms:.3f}, "
          f"kernel launches {launches} ({launches / args.frames:.1f}/frame)")
    print_top(events, kernels, 15)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out,
                                              "integrate_window.json"))
    del state
    rec = alloc_pass_record(device, depths, traj, runtime.gpu_identity())
    print(json.dumps({"alloc_pass": "client_vga", **rec}))


if __name__ == "__main__":
    main()
