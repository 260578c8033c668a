"""The endurance mission on the PyTorch/CUDA port: two robots stream
laps of an orbit with drifting odometry through the pipelined system —
a stream thread integrating windows, a serving thread meshing robot 0
live, a detector thread fusing, and the server's async solve — on one
card (the port of tools/endurance_run.py;
coxgraph_tpu_torch.eval.endurance). Writes the mission's JSON, one line,
to --out; sensor rate 2 robots × 10 Hz, so real time means ≥ 20 frames/s
of pipeline wall.

Run on a machine with a CUDA GPU:
    python tools/endurance_run_torch.py [--laps N] [--paced] [--no-loops]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import endurance

    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=6)
    ap.add_argument("--no-loops", action="store_true",
                    help="diagnostic: skip keyframes and fusions entirely "
                         "(isolates the stream and serving side)")
    ap.add_argument("--paced", action="store_true",
                    help="release each window at its sensor timestamp "
                         "(2 robots x 10 Hz): the sustained real-time "
                         "test, vs. the default max-throughput burst")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--out", default=endurance.DEFAULT_OUT)
    ap.add_argument("--work-dir", default=None,
                    help="directory for the live-mesh page and the final "
                         "mesh PLY (default: a temporary one)")
    args = ap.parse_args()

    device = runtime.require_cuda()
    print(f"device: {runtime.gpu_identity()}")
    art = endurance.endurance_run(device, laps=args.laps, paced=args.paced,
                                  no_loops=args.no_loops, scale=args.scale,
                                  out=args.out, work_dir=args.work_dir)
    print(json.dumps(art))
    print("ENDURANCE", "PASS" if art["ok"] else "FAIL")
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
