"""Readings of a cell's compared numbers on the card, several seeds in one
process: the program's (as a run reads them) or, with ``--control``, the
lower-precision control's (the reference in that precision standing in
for the program), from which the limits in ``workloads/<cell>.json`` are
set. Not part of a run.

    python3 slambench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control bfloat16]

One JSON line per seed: {"seed", "control", "checks": {name: value}}.
"""

import argparse
import gc
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

import torch  # noqa: E402

from slambench.harness import core  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    device = torch.device("cuda", 0)
    dtype = getattr(torch, args.control) if args.control else None
    c = core.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        d = c["driver"].Driver(c["config"], c["traffic"], seed, device)
        d.setup()
        d.window(args.seconds)
        checks = d.check(control=dtype)
        print(json.dumps({"seed": seed, "control": args.control,
                          "checks": {n: v for n, v, _ in checks}}),
              flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
