"""Point-cloud sensor (lidar-style) mapping on the PyTorch/CUDA port: a
robot streams UNORDERED point clouds (rendered depth backprojected and
shuffled) through HostMapper.step_points → the merged point-cloud
integrator → a submap chain → mesh and a surface-error gate against the
analytic scene (the port of examples/pointcloud_demo.py;
coxgraph_tpu_torch.eval.demos.pointcloud_demo).

Run on a machine with a CUDA GPU:
    python examples/pointcloud_demo_torch.py [--frames N] [--out DIR]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--out", default=None, help="directory for the PLY")
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import demos

    device = runtime.require_cuda()
    res = demos.pointcloud_demo(device, frames=args.frames,
                                scale=args.scale, out=args.out)
    print(f"device: {runtime.gpu_identity()}")
    print(json.dumps(res))
    print("DEMO", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
