"""The serving cell's open loop at several frame rates in one process, to
find the highest rate the port sustains with its map served once a
second (no growing backlog). Not part of a run.

    python3 slambench/tools/sweep.py --workload client_vga.serve \
        --rates 30,60,120,240 --seconds 8 --seed 1

One JSON line per rate: frames due, frames stepped, the p95 latency and
the lateness of the last frame stepped."""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slambench.harness import core  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    c = core.cell(args.workload)
    d = c["driver"].Driver(c["config"], c["traffic"], args.seed,
                           torch.device("cuda", 0))
    d.setup()
    d.keep_idx = set()
    for rate in (float(r) for r in args.rates.split(",")):
        d.rate = rate
        r = d._open_loop(args.seconds)
        due = int(np.ceil(args.seconds * rate))
        lat = np.asarray(r["latencies"])
        print(json.dumps({"rate_hz": rate, "due": due,
                          "stepped": r["stepped"],
                          "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                          "backlog": due - r["stepped"]}), flush=True)


if __name__ == "__main__":
    main()
