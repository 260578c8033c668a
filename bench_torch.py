#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (coxgraph_tpu_torch): TSDF
integration frames/s on one GPU (headline), the serving stages and the
two-phase registration solve — bench.py's one JSON line, from the port.

Run from the repository root on a machine with a CUDA GPU:

    python3 bench_torch.py [--frames N] [--no-solve]

The last line of stdout is one JSON object with bench.py's keys:
  {"metric": "tsdf_integration_fps", "value": N, "unit": "frames/s/chip",
   "vs_baseline": N, "extra_metrics": {<stage_benchmark's nine keys>,
   "two_phase_optimize_s", "two_phase_optimize_best_s", "solve_submaps",
   "solve_pairs"}}
Diagnostics go to stderr. Without a GPU it exits nonzero and prints no
JSON line; nothing falls back to the CPU, and a failing stage or solve
fails the run.

The operating point is BASELINE.md's (640x480 RGB-D, 5 cm voxels, 0.15 m
truncation, 10 m max range), the 30-frame orbit clip rendered on the card
(``eval.benchmarks``). ``vs_baseline`` is the headline over the same
pipeline on this machine's CPU — the port's plain torch versions of its
kernels, asked for explicitly — at min(frames, 8) frames, measured by
``bench_torch.py --cpu-baseline`` in a subprocess and cached in
.bench_cpu_baseline_torch.json with the CPU model, torch's thread count
and torch's version; a cache that differs in any of them is measured
again.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.eval import benchmarks as bm

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cpu_baseline_torch.json")
CPU_FRAMES = 8  # bench.py's baseline: min(frames, 8) frames on the CPU


def cpu_machine() -> dict:
    """What a CPU reading depends on: the CPU model, torch's intra-op
    thread count and torch's version."""
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"cpu": model, "threads": torch.get_num_threads(),
            "torch": torch.__version__}


def measure_cpu_fps(frames: int) -> float:
    """The headline's pipeline on the CPU, in this process: the first
    min(frames, 8) frames of the ``frames``-frame clip."""
    cpu = torch.device("cpu")
    n = min(frames, CPU_FRAMES)
    depths, colors, traj = bm.generate_frames(cpu, frames, render=n)
    return bm.tsdf_benchmark(depths, colors, traj, n_frames=n)


def _measure_in_subprocess(frames: int) -> float:
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"),
         "--cpu-baseline", "--frames", str(frames),
         "--threads", str(torch.get_num_threads())],
        capture_output=True, text=True, cwd=REPO, timeout=3600)
    if out.returncode != 0:
        raise RuntimeError("CPU baseline run failed (rc "
                           f"{out.returncode}):\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["fps"]


def cpu_baseline(frames: int, path: str = CACHE,
                 measure=_measure_in_subprocess) -> dict:
    """The CPU reading cached at ``path`` → {"fps", "clip", "cpu",
    "threads", "torch", "cached"}. Measured (``measure(frames)``) and
    written when the file is missing, or when its clip length, CPU
    model, thread count or torch version differs from this machine's."""
    want = dict(cpu_machine(), clip=frames)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        rec = {}
    if all(rec.get(k) == v for k, v in want.items()) and "fps" in rec:
        return dict(rec, cached=True)
    rec = dict(want, fps=measure(frames))
    with open(path, "w") as f:
        json.dump(rec, f)
    return dict(rec, cached=False)


def run(device, frames: int = bm.N_FRAMES, solve: bool = True,
        cache: str = CACHE) -> dict:
    """Render the clip on ``device``, measure the headline, the serving
    stages and (``solve``) the two-phase optimize there, and print
    bench.py's JSON line as the last line of stdout → that line's dict.
    ``cache``: the CPU baseline's file (``cpu_baseline``)."""
    log = sys.stderr
    depths, colors, traj = bm.generate_frames(device, frames)

    k1 = runtime.launches("k1")
    fps = bm.tsdf_benchmark(depths, colors, traj, n_frames=frames)
    print(f"# tsdf_integration_fps {fps:.2f} on {device}: one warm "
          f"window, then 4 timed windows x {frames} frames, one fence; K1 "
          f"launches {runtime.launches("k1") - k1}", file=log)

    extra = bm.stage_benchmark(depths, colors, traj)
    print(f"# stages: {json.dumps(extra)}", file=log)
    if solve:
        s = bm.solve_benchmark(device=device)
        extra.update({
            "two_phase_optimize_s": round(s["solve_s"], 3),
            "two_phase_optimize_best_s": round(s["solve_best_s"], 3),
            "solve_submaps": s["submaps"],
            "solve_pairs": s["pairs"],
        })

    base = cpu_baseline(frames, cache)
    print(f"# vs_baseline = this fps / {base['fps']:.2f} frames/s of the "
          f"same pipeline on the host CPU (the port's plain torch versions "
          f"of its kernels, the first {min(frames, CPU_FRAMES)} frames) on "
          f"{base['cpu']}, {base['threads']} threads, torch "
          f"{base['torch']} ({'cached' if base['cached'] else 'measured'}"
          f" in {os.path.basename(cache)})", file=log)
    result = {
        "metric": "tsdf_integration_fps",
        "value": round(fps, 2),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps / base["fps"], 2),
        "extra_metrics": extra,
    }
    print(json.dumps(result), flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=bm.N_FRAMES)
    ap.add_argument("--no-solve", action="store_true",
                    help="skip the two-phase optimize's four keys")
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="(internal) measure the CPU pipeline, print "
                         '{"fps": N}')
    ap.add_argument("--threads", type=int, default=None,
                    help="(internal) torch threads for --cpu-baseline")
    args = ap.parse_args()

    if args.cpu_baseline:
        if args.threads:
            torch.set_num_threads(args.threads)
        print(json.dumps({"fps": measure_cpu_fps(args.frames)}))
        return

    device = runtime.require_cuda()
    print(f"# device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{runtime.gpu_identity()}", file=sys.stderr)
    run(device, frames=args.frames, solve=not args.no_solve)


if __name__ == "__main__":
    main()
