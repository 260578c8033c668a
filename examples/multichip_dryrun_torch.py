"""The multi-robot dry run on the PyTorch/CUDA port (the port of
__graft_entry__.py's dry run; coxgraph_tpu_torch.eval.dryrun): n robots
integrate three rendered frames each through the fleet step, the
distributed LM reconciles their drifting odometry with intra- and
inter-robot closures, then the block-sharded ESDF and the sharded merge
run over the ranks.

On a machine with a CUDA GPU, every robot in this process:
    python examples/multichip_dryrun_torch.py [N]
On the CPU, over W gloo ranks (spawned), N / W robots each:
    python examples/multichip_dryrun_torch.py [N] --cpu --ranks W
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import torch

    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import dryrun

    device = torch.device("cpu") if args.cpu else runtime.require_cuda()
    if device.type == "cuda":
        print(f"device: {runtime.gpu_identity()}")
    fn, fargs = dryrun.entry(device)
    fn(*fargs)
    print("entry() OK")
    if args.ranks == 1:
        dryrun.dryrun_multichip(args.n, device)
    else:
        # gloo: two ranks on one card need it too (NCCL refuses them)
        dryrun.spawn_dryrun(args.n, args.ranks, device, backend="gloo")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
