#!/usr/bin/env python3
"""bench_torch.py in fresh processes, and the headline's windows one by
one, on a CUDA GPU.

    python3 tools/bench_torch_runs.py [--runs 10] [--out FILE]
    python3 tools/bench_torch_runs.py --windows R

Default: runs ``python3 bench_torch.py`` ``--runs`` times, one after
another, each in a fresh process from the repository root, and records
for each run its JSON line, its process wall, its stderr diagnostics,
the card's nvidia-smi name and power limit, and the SM clock, power draw
and temperature that ``nvidia-smi -lms 200`` sampled while it ran. Writes
one JSON object a run to ``--out`` and prints the headline's median, min
and max. A run that fails fails the script.

``--windows R``: in this process, R times over, tsdf_benchmark's
protocol at the bench point (one warm window on a fresh map, then four
windows on another fresh map and one fence), with host timestamps
between the timed windows and no added sync, so the spread of the
headline can be placed: for each window the wall until its last launch
was issued, the thread's CPU time in it, the caching allocator's new
device segments (cudaMalloc calls) and the SM clock range that
``nvidia-smi -lms 50`` sampled in it; then the fence's wait and the
rate, computed as tsdf_benchmark computes it.
Fails when no CUDA GPU is present.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

@contextlib.contextmanager
def nvidia_smi_samples(period_ms: int):
    """Sample the card every ``period_ms`` while the body runs → a list,
    filled on exit, of (unix s, SM MHz, power draw W, temperature °C)."""
    rows = []
    proc = subprocess.Popen(
        ["nvidia-smi",
         "--query-gpu=timestamp,clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield rows
    finally:
        proc.terminate()
        for line in proc.communicate(timeout=30)[0].splitlines():
            try:
                ts, *vals = line.split(",")
                rows.append((datetime.datetime.strptime(
                    ts.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp(),
                    *map(float, vals)))
            except ValueError:
                continue


def one_run(ident: str) -> dict:
    """One fresh ``bench_torch.py`` process → its record."""
    with nvidia_smi_samples(200) as rows:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                             capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"bench_torch.py exited {out.returncode}")
    clocks = {"n": len(rows)}
    if rows:
        _, sm, watts, temp = zip(*rows)
        clocks.update(sm_mhz_min=min(sm), sm_mhz_max=max(sm),
                      watts_max=max(watts), temp_c_max=max(temp))
    return {"line": json.loads(out.stdout.strip().splitlines()[-1]),
            "wall_s": wall, "gpu": ident, "clocks": clocks,
            "stderr": [l for l in out.stderr.splitlines()
                       if l.startswith("# ")]}


def runs(n: int, out_path: str) -> None:
    from coxgraph_tpu_torch import runtime

    runtime.require_cuda()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fps = []
    with open(out_path, "w") as f:
        for i in range(n):
            rec = one_run(runtime.gpu_identity())
            f.write(json.dumps(rec) + "\n")
            f.flush()
            fps.append(rec["line"]["value"])
            print(f"run {i + 1}/{n}: {json.dumps(rec['line'])} wall "
                  f"{rec['wall_s']:.1f} s; clocks {json.dumps(rec['clocks'])}"
                  f" — {rec['gpu']}", flush=True)
    print(json.dumps({"runs": n, "fps": fps,
                      "median": statistics.median(fps), "min": min(fps),
                      "max": max(fps), "gpu": runtime.gpu_identity()}))


def windows(repeats: int) -> None:
    from coxgraph_tpu_torch import runtime
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.mapper import submap_mapper as sm

    device = runtime.require_cuda()
    ident = runtime.gpu_identity()
    cfg = bm._mapper_config()
    depths, colors, traj = bm.generate_frames(device)
    n = depths.shape[0]
    ts = torch.arange(n, dtype=torch.float32, device=device) * 0.05

    def fresh():
        s = sm.create_mapper(cfg, device)
        return sm.start_submap(cfg, s, traj[0], ts[0])

    def fence(s):
        torch.cuda.synchronize(device)
        return float(s.collection.layers.weight.sum())

    def segments():
        return torch.cuda.memory_stats(device).get(
            "segment.all.allocated", 0)

    rows = []
    with nvidia_smi_samples(50) as clocks:
        for r in range(repeats):
            s = fresh()
            w0 = time.time()
            sm.integrate_batch(cfg, s, depths, colors, traj, ts)
            fence(s)
            warm = (time.time() - w0, w0)
            s = fresh()
            fence(s)
            # tsdf_benchmark's timed region, with host timestamps between
            # windows and no added sync
            marks = [(time.time(), time.perf_counter(), time.thread_time(),
                      segments())]
            for _ in range(4):
                sm.integrate_batch(cfg, s, depths, colors, traj, ts)
                marks.append((time.time(), time.perf_counter(),
                              time.thread_time(), segments()))
            fence(s)
            end = (time.time(), time.perf_counter())
            rows.append((warm, marks, end))

    def mhz(t0, t1):
        got = [c[1] for c in clocks if t0 <= c[0] <= t1]
        return f"{min(got):.0f}-{max(got):.0f}" if got else "-"

    for r, (warm, marks, end) in enumerate(rows):
        parts = []
        for a, b in zip(marks, marks[1:]):
            parts.append(f"{(b[1] - a[1]) * 1e3:.1f}/{(b[2] - a[2]) * 1e3:.1f}"
                         f"/+{b[3] - a[3]}/{mhz(a[0], b[0])}")
        wait = (end[1] - marks[-1][1]) * 1e3
        fps = 4 * n / (end[1] - marks[0][1])
        print(f"windows {r + 1}/{repeats}: warm {warm[0] * 1e3:.1f} ms at "
              f"{mhz(warm[1], warm[1] + warm[0])} MHz; timed (issue wall ms"
              f" / thread CPU ms / new allocator segments / SM MHz): "
              + " | ".join(parts) + f"; fence {wait:.1f} ms at "
              f"{mhz(marks[-1][0], end[0])} MHz; {fps:.2f} frames/s "
              f"— {ident}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "bench_torch_runs.jsonl"))
    ap.add_argument("--windows", type=int, default=0,
                    help="time each window of R fresh maps in this process "
                         "instead")
    args = ap.parse_args()
    if args.windows:
        windows(args.windows)
    else:
        runs(args.runs, args.out)


if __name__ == "__main__":
    main()
