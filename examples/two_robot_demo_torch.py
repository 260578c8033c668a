"""Two-robot collaborative reconstruction demo on the PyTorch/CUDA port:
two robots with drifting odometry stream RGB-D frames through
VIOInterface, the loop detector finds cross-robot closures, and the
fusion server aligns the client frames, solves the global pose graph on a
background thread and builds one global mesh (the port of
examples/two_robot_demo.py; coxgraph_tpu_torch.eval.demos).

Run on a machine with a CUDA GPU:
    python examples/two_robot_demo_torch.py [--frames N] [--out DIR]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default=None,
                    help="directory for global_mesh.ply and client*.tum")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--reg-weight", type=float, default=30.0)
    ap.add_argument("--skip-mesh", action="store_true")
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import demos

    device = runtime.require_cuda()
    res = demos.two_robot_demo(device, frames=args.frames, scale=args.scale,
                               reg_weight=args.reg_weight,
                               skip_mesh=args.skip_mesh, out=args.out)
    print(f"device: {runtime.gpu_identity()}")
    print(json.dumps(res))
    print("DEMO", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
