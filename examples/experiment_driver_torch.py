"""Scripted multi-robot experiment over the bus on the PyTorch/CUDA port —
the reference's shell orchestration end to end (the port of
examples/experiment_driver.py; coxgraph_tpu_torch.eval.demos
.distributed_demo):

  1. toggle mapping ON for every robot   (scripts/start_mapping.sh:2-5)
  2. robots map while the server fuses   (run_experiment_cvg.launch)
  3. finish_map on every robot           (finish_experiment.sh:3-4)
  4. get_final_global_mesh → PLY         (finish_experiment.sh:5)
  5. get_pose_history → TUM trajectory   (finish_experiment.sh:6)

Robots run in their own OS processes on the GPU and start with mapping
DISABLED. The PLY and the TUM file are written to --out.

Run on a machine with a CUDA GPU:
    python examples/experiment_driver_torch.py --out DIR [--frames N]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="directory for the mesh PLY and the TUM file")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--scale", type=float, default=0.25)
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import demos

    device = runtime.require_cuda()
    res = demos.distributed_demo(device, frames=args.frames,
                                 scale=args.scale, out=args.out)
    print(f"device: {runtime.gpu_identity()}")
    print(f"global mesh: {res['triangles']} tris → "
          f"{os.path.join(args.out, 'coxgraph_server_mesh.ply')}")
    print(f"pose history: {res['pose_rows']} poses → "
          f"{os.path.join(args.out, 'coxgraph_server_traj.txt')}")
    print(f"client-frame alignment error: {res['align_err']:.3f}")
    print(json.dumps(res["gates"]))
    print("EXPERIMENT DRIVER", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
