"""A copy of the benchmark at a size the CPU holds (80×60 frames, 8³
blocks, a few submaps), for the tests: the same files, cells, drivers and
readers, with only the sizes in the configuration and traffic files cut.
Runs go through ``harness.core.run`` with the look for a chip skipped, in
a subprocess, so the copy imports as ``slambench``."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

CAMERA = {"width": 80, "height": 60, "fx": 65.625, "fy": 65.625,
          "cx": 39.5, "cy": 29.5}
TSDF = {"voxels_per_side": 8, "grid_dim": 32, "max_blocks": 512,
        "max_touched_blocks": 256}


def _edit(path: str, fn) -> None:
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def _cfg(c: dict) -> None:
    c["camera"].update(CAMERA)
    c["tsdf"].update(TSDF)
    if "server" in c:
        c["mapper"].update(max_submaps=6, submap_interval=2.0)
        c["server"].update(max_submaps=12, refuse_interval=4.0)
        c["registration"].update(max_points=256, max_reg_blocks=128)
    else:
        c["mapper"].update(max_submaps=4, submap_interval=20 / 30)


def _mix(t: dict) -> None:
    if t["driver"] == "stream":
        t.update(window_frames=10, lap_frames=20, mission_submaps=3,
                 max_frames=3000, trace_windows=2)
    elif t["driver"] == "serve":
        t.update(window_frames=10, lap_frames=20, mission_submaps=3,
                 max_frames=3000, rate_hz=10, serve_period_s=0.5,
                 trace_seconds=1.0)
    else:
        t.update(lap_frames=60, submaps_per_robot=6, trace_optimizes=1)
        t["fusion"].update(interval=4.0, to_offset=1.0)


def make(root: str) -> str:
    """A tiny copy of the benchmark under ``root`` → the copy's root
    (``root``/slambench)."""
    dst = os.path.join(root, "slambench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    for name in os.listdir(os.path.join(dst, "configs")):
        _edit(os.path.join(dst, "configs", name), _cfg)
    for name in os.listdir(os.path.join(dst, "traffic")):
        if name.endswith(".json"):
            _edit(os.path.join(dst, "traffic", name), _mix)
    return dst


RUNNER = """
import sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import torch
torch.set_num_threads(2)
{patch}
from slambench.harness import core
sys.exit(core.run({argv!r}, time.perf_counter(), device_check=False))
"""


def run(root: str, cell: str, seed: int = 7, seconds: float = 1.0,
        trace: int = 0, patch: str = "", timeout: float = 600):
    """One run of ``cell`` from the copy under ``root`` on the CPU →
    (exit code, the last stdout line parsed or None, stderr)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = RUNNER.format(root=root, repo=REPO, argv=argv, patch=patch)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, cwd=root,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, line, p.stderr


CONTROL = """
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import torch
torch.set_num_threads(2)
from slambench.harness import core
c = core.cell({cell!r})
d = c["driver"].Driver(c["config"], c["traffic"], {seed}, torch.device("cpu"))
d.setup()
d.window({seconds})
print(json.dumps(d.check(control=torch.bfloat16)))
"""


def control(root: str, cell: str, seed: int = 7, seconds: float = 1.0):
    """The bf16 control of ``cell`` from the copy under ``root`` → its
    [(name, value, limit)]."""
    code = CONTROL.format(root=root, repo=REPO, cell=cell, seed=seed,
                          seconds=seconds)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
