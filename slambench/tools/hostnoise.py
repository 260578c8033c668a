"""What moves a host-paced cell's rate between windows: one cell set up
once, then several windows, each with the host's readings beside its
rate. Not part of a run.

    python3 slambench/tools/hostnoise.py --workload client_vga.stream \
        --seed 1 --windows 6 --seconds 5 [--gc freeze]

Before each window: a fixed pure-Python loop (the interpreter's speed)
and 4,000 tiny kernel launches (the launch path's speed), each timed.
Over each window: the thread's CPU time and the cyclic garbage
collector's passes and time. ``--gc freeze`` moves every object of the
set-up out of the collector's reach first. One JSON line per window.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))

import torch  # noqa: E402

from slambench.harness import core  # noqa: E402


def py_loop_s() -> float:
    t = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return time.perf_counter() - t


def launches_s(x) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(4000):
        x.add_(1.0)
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host


class GcTimer:
    def __init__(self):
        self.t = 0.0
        self.n = [0, 0, 0]
        self._t0 = None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.t += time.perf_counter() - self._t0
            self.n[info["generation"]] += 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--gc", choices=("on", "freeze"), default="on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    device = torch.device("cuda", 0)
    c = core.cell(args.workload)
    d = c["driver"].Driver(c["config"], c["traffic"], args.seed, device)
    d.setup()
    if args.gc == "freeze":
        gc.collect()
        gc.freeze()
    # the stream's window runs bare, its rate in the record, once the
    # driver holds a record, as in a traced run
    bare = getattr(d, "rec", 0) is None
    if bare:
        d.rec = {}
    x = torch.zeros(16, device=device)
    gct = GcTimer()
    print(json.dumps({"gc_objects": len(gc.get_objects()),
                      "affinity": sorted(os.sched_getaffinity(0)),
                      "gc_mode": args.gc}), flush=True)
    for w in range(args.windows):
        loop = py_loop_s()
        launch = launches_s(x)
        th0, g0, gn0 = time.thread_time(), gct.t, list(gct.n)
        t0 = time.perf_counter()
        e2e = d.window(args.seconds)
        wall = time.perf_counter() - t0
        th1 = time.thread_time()
        # the stream's frames/s; else ms per call of the window
        rate = d.rec.get("frames_per_s",
                         1e3 * wall / e2e["attempted"]) if bare else next(
            v for k, v in e2e.items() if k.endswith("_ms"))
        print(json.dumps({
            "window": w, "rate": rate, "py_loop_s": loop,
            "launch_4000_s": launch, "thread_cpu_s": th1 - th0,
            "gc_s": gct.t - g0,
            "gc_passes": [a - b for a, b in zip(gct.n, gn0)]}), flush=True)


if __name__ == "__main__":
    main()
