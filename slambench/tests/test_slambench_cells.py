"""The benchmark at a size the CPU holds: each cell agrees with the plain
reference through the port's CPU twins; the lower-precision control and
each fault planted under the timed path make ``correct`` false; the last
line holds the contract's keys; a cell, a configuration and a metric
added as new files run with no file edited."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from . import tiny

CELLS = ("client_vga.stream", "cvg_two_client.solve", "client_vga.serve")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}

# faults planted under the timed path, per cell: the state left unchanged,
# half of each batch left out, an answer altered where it is produced
FAULTS = {
    "client_vga.stream": {
        "unchanged": """
from coxgraph_tpu_torch.mapper import submap_mapper as sm
sm.HostMapper.step_batch = lambda self, d, c, T, ts: 0
""",
        "half_batch": """
from coxgraph_tpu_torch.mapper import submap_mapper as sm
_step = sm.HostMapper.step_batch
def _half(self, d, c, T, ts):
    n = len(ts) // 2
    return _step(self, d[:n], c[:n], T[:n], ts[:n])
sm.HostMapper.step_batch = _half
""",
        "altered": """
from coxgraph_tpu_torch.ops import cuda_tsdf, tsdf
_upd = cuda_tsdf.update_blocks
def _bad(spec, cfg, intr, layers, k, slots, mask, *a):
    _upd(spec, cfg, intr, layers, k, slots, mask, *a)
    rows = (k.long() * spec.max_blocks + slots.long())[mask]
    layers.sdf.view(-1, layers.sdf.shape[-1])[rows] += 0.01
tsdf.cuda_tsdf.update_blocks = _bad
""",
    },
    "cvg_two_client.solve": {
        "unchanged": """
from coxgraph_tpu_torch.server import fusion_server as fs
fs.CoxgraphServer.optimize = lambda self, push_updates=True: {}
""",
        "half_batch": """
import dataclasses
from coxgraph_tpu_torch.server import global_opt, fusion_server as fs
_solve = global_opt.optimize_two_phase
def _half(poses, constraints, *a, **k):
    valid = constraints.valid.clone()
    valid[1::2] = False
    return _solve(poses, dataclasses.replace(constraints, valid=valid),
                  *a, **k)
fs.global_opt.optimize_two_phase = _half
""",
        "altered": """
from coxgraph_tpu_torch.server import global_opt, fusion_server as fs
_solve = global_opt.optimize_two_phase
def _bad(*a, **k):
    poses, info = _solve(*a, **k)
    poses = poses.clone()
    poses[:, 4] += 0.05
    return poses, info
fs.global_opt.optimize_two_phase = _bad
""",
    },
    "client_vga.serve": {
        "unchanged": """
from coxgraph_tpu_torch.mapper import submap_mapper as sm
sm.HostMapper.step = lambda self, *a, **k: False
""",
        "half_batch": """
from coxgraph_tpu_torch.mapper import submap_mapper as sm
_step = sm.HostMapper.step
def _half(self, depth, color, T, t):
    self._n = getattr(self, "_n", 0) + 1
    return _step(self, depth, color, T, t) if self._n % 2 else False
sm.HostMapper.step = _half
""",
        "altered": """
from coxgraph_tpu_torch.mapper import submap_mapper as sm
_mesh = sm.HostMapper.live_mesh
def _bad(self, *a, **k):
    v, c = _mesh(self, *a, **k)
    return v + 0.01, c
sm.HostMapper.live_mesh = _bad
""",
    },
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("bench"))
    tiny.make(r)
    return r


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_reference(root, cell):
    rc, line, err = tiny.run(root, cell, seed=3000000019)
    assert rc == 0, err[-3000:]
    assert line["correct"], line["checks"]
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    with open(os.path.join(tiny.BENCH, "workloads", cell + ".json")) as f:
        e2e = json.load(f)["end_to_end"]
    assert all(line["metrics"][n]["value"] > 0 for n in e2e)
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    # the numbers compared close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(root, cell):
    checks = tiny.control(root, cell, seed=11)
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_fails(root, cell, fault):
    rc, line, err = tiny.run(root, cell, seed=13, patch=FAULTS[cell][fault])
    assert rc == 0, err[-3000:]
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(root, cell):
    rc, line, err = tiny.run(root, cell, seed=17, trace=1)
    assert rc == 0, err[-3000:]
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["metrics"] and "setup_s" not in line["metrics"]
    with open(os.path.join(tiny.BENCH, "workloads", cell + ".json")) as f:
        e2e = set(json.load(f)["end_to_end"])
    from slambench.harness import core
    for name, m in line["metrics"].items():
        mod = core.load_module(os.path.join(tiny.BENCH, "metrics",
                                            name + ".py"))
        assert mod.MOVES in e2e and m["unit"] == mod.UNIT
        assert m["value"] >= 0


def test_new_files_only(tmp_path):
    """A new configuration, cell and per-layer metric, added as files."""
    root = str(tmp_path)
    b = tiny.make(root)
    with open(os.path.join(b, "configs", "client_vga.json")) as f:
        cfg = json.load(f)
    cfg["odometry"]["z_bias"] = 0.0
    with open(os.path.join(b, "configs", "client_flat.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "workloads", "client_vga.stream.json")) as f:
        w = json.load(f)
    w["config"] = "client_flat"
    with open(os.path.join(b, "workloads", "client_flat.stream.json"),
              "w") as f:
        json.dump(w, f)
    with open(os.path.join(b, "metrics", "frames_traced."
                           "device_ms_per_frame.py"), "w") as f:
        f.write('MOVES = "device_ms_per_frame"\nUNIT = "frames"\n\n\n'
                'def read(rec):\n    return rec.get("frames")\n')
    rc, line, err = tiny.run(root, "client_flat.stream", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"]
    assert line["metrics"]["frames_traced.device_ms_per_frame"]["value"] > 0
    # a metric of another end-to-end metric stays out of this cell
    assert not any(n.endswith(".optimize_ms") for n in line["metrics"])


def test_no_jax_in_a_run(root):
    show = ("import atexit, sys\natexit.register(lambda: print('MODULES', "
            "sorted({m.split('.')[0] for m in sys.modules}), "
            "file=sys.stderr))\n")
    rc, line, err = tiny.run(root, "client_vga.stream", patch=show)
    assert rc == 0, err[-3000:]
    mods = eval(err.strip().splitlines()[-1].split("MODULES", 1)[1])
    assert "coxgraph_tpu_torch" in mods
    assert not {"jax", "jaxlib", "flax", "coxgraph_tpu"} & set(mods)


def test_jax_loaded_refuses_the_run(root):
    fake = "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n"
    rc, line, err = tiny.run(root, "client_vga.stream", patch=fake)
    assert rc != 0 and line is None
    assert "jax" in err


def test_yardstick_imports_nothing_of_the_port():
    import ast

    banned = {"jax", "jaxlib", "flax", "coxgraph_tpu", "coxgraph_tpu_torch"}
    for sub in ("reference", "traffic", "metrics"):
        d = os.path.join(tiny.BENCH, sub)
        for name in os.listdir(d):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(d, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in banned, (sub, name, n)


def test_missing_cell_files_fail(tmp_path):
    """A checkout that holds only the benchmark's files cannot run."""
    shutil.copytree(tiny.BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                        "client_vga.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
