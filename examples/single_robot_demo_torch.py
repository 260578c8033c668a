"""Single-robot demo on the PyTorch/CUDA port: a synthetic RGB-D clip →
submap mapping with drifting odometry → a loop closure → local PGO →
the merged TSDF → mesh PLY + TUM trajectory + ATE report (the port of
examples/single_robot_demo.py; coxgraph_tpu_torch.eval.demos).

Run on a machine with a CUDA GPU:
    python examples/single_robot_demo_torch.py [--frames N] [--out DIR]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=None,
                    help="directory for global_mesh.ply and trajectory.tum")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="camera resolution scale (1.0 = 640x480)")
    args = ap.parse_args()

    import numpy as np

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import demos

    device = runtime.require_cuda()
    res = demos.single_robot_demo(device, frames=args.frames,
                                  scale=args.scale, out=args.out)
    print(f"device: {runtime.gpu_identity()}")
    print(f"integrated {res['frames']} frames → {res['submaps']} submaps "
          f"in {res['integrate_s']:.1f}s ({res['fps']:.1f} fps)")
    print(f"ATE raw odometry: {res['ate_raw'] * 100:.2f} cm  "
          f"after loop+PGO: {res['ate_opt'] * 100:.2f} cm")
    print(f"merged map: {res['merged_blocks']} blocks, mesh "
          f"{res['triangles']} tris, surface err p90 "
          f"{res['surf_p90'] * 100:.2f} cm")
    print(json.dumps({k: v for k, v in res.items()
                      if not isinstance(v, np.ndarray)}))
    print("DEMO", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
