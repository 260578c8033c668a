"""A copy of the benchmark at a size the CPU holds (80×60 frames, 8³
blocks, a few submaps), for the tests: the same files, cells, drivers and
readers, with only the sizes in the configuration and traffic files cut.
Runs go through ``harness.core.run`` with the look for a chip skipped, in
a subprocess, so the copy imports as ``slambench``.

The cuts come from the files: for each cell ``workloads/<cell>.json``, the
common camera and tsdf cut below, then the ``TINY`` of the driver its
traffic file names (``drivers/<driver>.py``), which cuts the traffic file
and the configuration sections that driver reads. A section no cut names
is left as it is. The cells are the workload files, and each cell's
planted faults are ``tests/faults/<cell>/<fault>.py``."""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

COMMON = {"camera": {"width": 80, "height": 60, "fx": 65.625, "fy": 65.625,
                     "cx": 39.5, "cy": 29.5},
          "tsdf": {"voxels_per_side": 8, "grid_dim": 32, "max_blocks": 512,
                   "max_touched_blocks": 256}}
# the kinds of fault every cell plants under its timed path: the state
# left unchanged, half of each batch left out, an answer altered where it
# is produced
KINDS = ("unchanged", "half_batch", "altered")


def cells(bench: str = BENCH) -> list:
    """The cells of the benchmark under ``bench``: its workload files."""
    return sorted(os.path.basename(p)[:-len(".json")] for p in
                  glob.glob(os.path.join(bench, "workloads", "*.json")))


def faults(bench: str = BENCH) -> dict:
    """{cell: {fault: the code that plants it}} from
    ``tests/faults/<cell>/<fault>.py``, the three kinds first."""
    out = {}
    for c in cells(bench):
        d = os.path.join(bench, "tests", "faults", c)
        names = [os.path.basename(p)[:-len(".py")]
                 for p in glob.glob(os.path.join(d, "*.py"))]
        out[c] = {}
        for f in sorted(names, key=lambda f: (
                KINDS.index(f) if f in KINDS else len(KINDS), f)):
            with open(os.path.join(d, f + ".py")) as fh:
                out[c][f] = fh.read()
    return out


def driver_cut(path: str) -> dict:
    """A driver module's ``TINY`` ({"mix": ..., "config": ...}), read
    from its source without running it ({} where it has none)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "TINY"):
            return eval(compile(ast.Expression(node.value), path, "eval"),
                        {"__builtins__": {}})
    return {}


def _merge(d: dict, cut: dict) -> None:
    """``cut`` into ``d``: a nested cut into the section of the same name
    where ``d`` has one (none: skipped), any other value set."""
    for k, v in cut.items():
        if isinstance(v, dict):
            if isinstance(d.get(k), dict):
                _merge(d[k], v)
        else:
            d[k] = v


def _join(a: dict, b: dict, where: str) -> None:
    """Cut ``b`` joined into cut ``a``; two values for one key raise."""
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            _join(a[k], v, f"{where}.{k}")
        elif a.setdefault(k, v) != v:
            raise ValueError(f"{where}.{k}: cut to {a[k]!r} and to {v!r} "
                             "by the drivers of two cells")


def cut(dst: str) -> None:
    """Cut the configuration and traffic files of every cell of the copy
    ``dst`` to the CPU's size, each file once."""
    cuts = {}
    for c in cells(dst):
        with open(os.path.join(dst, "workloads", c + ".json")) as f:
            w = json.load(f)
        cfg = os.path.join("configs", w["config"] + ".json")
        mix = os.path.join("traffic", w["traffic"] + ".json")
        with open(os.path.join(dst, mix)) as f:
            drv = json.load(f)["driver"]
        t = driver_cut(os.path.join(dst, "drivers", drv + ".py"))
        for path, val in ((cfg, COMMON), (cfg, t.get("config", {})),
                          (mix, t.get("mix", {}))):
            _join(cuts.setdefault(path, {}), json.loads(json.dumps(val)),
                  path)
    for path, val in cuts.items():
        with open(os.path.join(dst, path)) as f:
            d = json.load(f)
        _merge(d, val)
        with open(os.path.join(dst, path), "w") as f:
            json.dump(d, f, indent=1)


def make(root: str, add=None) -> str:
    """A tiny copy of the benchmark under ``root`` → the copy's root
    (``root``/slambench). ``add(copy)``, where given, adds files to the
    copy at full size before the cut, as a later change adds them."""
    dst = os.path.join(root, "slambench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    if add is not None:
        add(dst)
    cut(dst)
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
