"""Multi-process collaborative mapping over the native message bus on the
PyTorch/CUDA port: each robot runs in its own OS process on the GPU,
mapping its clip and serving its submaps over the bus; this process runs
the fusion server against RemoteClient proxies, fuses the two robots and
builds the global mesh (the port of examples/distributed_demo.py;
coxgraph_tpu_torch.eval.demos.distributed_demo).

Run on a machine with a CUDA GPU:
    python examples/distributed_demo_torch.py [--frames N]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--scale", type=float, default=0.25)
    args = ap.parse_args()

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import demos

    device = runtime.require_cuda()
    res = demos.distributed_demo(device, frames=args.frames,
                                 scale=args.scale)
    print(f"device: {runtime.gpu_identity()}")
    print(f"fusion accepted: {res['gates']['fusion_accepted']}, server "
          f"submaps: {res['server_submaps']}")
    print(f"client-frame alignment error: {res['align_err']:.3f}")
    print(f"global mesh: {res['triangles']} triangles")
    print(json.dumps({k: v for k, v in res.items() if k != "recovered"}))
    print("DISTRIBUTED DEMO", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
