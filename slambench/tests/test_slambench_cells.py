"""The benchmark at a size the CPU holds: each cell agrees with the plain
reference through the port's CPU twins; the lower-precision control and
each fault planted under the timed path make ``correct`` false; the last
line holds the contract's keys; cells, configurations, drivers, faults
and metrics added as new files run with no file edited."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from . import tiny

CELLS = tiny.cells()
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
# faults planted under the timed path, per cell (tests/faults/<cell>/)
FAULTS = tiny.faults()


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


@pytest.mark.parametrize("cell", CELLS)
def test_cell_plants_every_kind_of_fault(cell):
    assert set(tiny.KINDS) <= set(FAULTS[cell]), FAULTS[cell].keys()


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


# a cell of a new kind, as a later change would add it: a driver of its
# own (the stream with the port's tracing on around its traced stretch)
# whose CPU cut names a configuration section tiny.py does not know, a
# traffic file with no key of another driver's, its three faults, and
# readers of the program's spans and counters
PROBE_DRIVER = '''"""The stream, its traced stretch with the port's tracing on."""

from slambench.drivers import stream
from slambench.harness import port

TINY = {"mix": {"window_frames": 10, "lap_frames": 20, "mission_submaps": 3,
                "max_frames": 3000, "trace_windows": 2},
        "config": {"mapper": {"max_submaps": 4, "submap_interval": 20 / 30},
                   "probe": {"budget": 8}}}


class Driver(stream.Driver):
    def trace(self):
        before = port.counters()
        with port.tracing():
            rec = super().trace()
        after = port.counters()
        rec["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
        return rec
'''
PROBE_READERS = {
    "alloc_spans_per_frame.device_ms_per_frame": '''MOVES = "device_ms_per_frame"
UNIT = "spans"


def read(rec):
    s = rec.get("spans", {}).get("tsdf.alloc")
    if not s or not rec.get("frames"):
        return None
    return s["n"] / rec["frames"]
''',
    "frames_counted.device_ms_per_frame": '''MOVES = "device_ms_per_frame"
UNIT = "frames"


def read(rec):
    c = rec.get("counters", {}).get("mapper.frames")
    if not c:
        return None
    return c / (rec["frames"] + rec["sync_frames"])
''',
}


def _add_new_files(b: str) -> None:
    """Files a later change adds, at full size: a configuration, cell and
    metric on an existing driver, and a cell of a new driver kind."""
    def load(*p):
        with open(os.path.join(b, *p)) as f:
            return json.load(f)

    def save(d, *p):
        os.makedirs(os.path.join(b, *p[:-1]), exist_ok=True)
        with open(os.path.join(b, *p), "w") as f:
            if isinstance(d, str):
                f.write(d)
            else:
                json.dump(d, f)

    cfg = load("configs", "client_vga.json")
    w = load("workloads", "client_vga.stream.json")
    flat = dict(cfg, odometry=dict(cfg["odometry"], z_bias=0.0))
    save(flat, "configs", "client_flat.json")
    save(dict(w, config="client_flat"), "workloads",
         "client_flat.stream.json")
    save('MOVES = "device_ms_per_frame"\nUNIT = "frames"\n\n\n'
         'def read(rec):\n    return rec.get("frames")\n',
         "metrics", "frames_traced.device_ms_per_frame.py")
    save(dict(cfg, probe={"budget": 1000}, extra={"max_submaps": 99}),
         "configs", "client_probe.json")
    save(dict(load("traffic", "stream.json"), driver="probe"),
         "traffic", "probe.json")
    save(dict(w, config="client_probe", traffic="probe"), "workloads",
         "client_probe.probe.json")
    save(PROBE_DRIVER, "drivers", "probe.py")
    for name, text in PROBE_READERS.items():
        save(text, "metrics", name + ".py")
    for f, text in FAULTS["client_vga.stream"].items():
        save(text, "tests", "faults", "client_probe.probe", f + ".py")


def test_new_files_only(tmp_path):
    """A new configuration, cell and per-layer metric on an existing
    driver, and a cell of a new driver kind, added as files."""
    from concurrent.futures import ThreadPoolExecutor

    root = str(tmp_path)
    b = tiny.make(root, add=_add_new_files)
    new = "client_probe.probe"
    assert "client_flat.stream" in tiny.cells(b) and new in tiny.cells(b)
    assert tiny.faults(b)[new] == FAULTS["client_vga.stream"]
    with open(os.path.join(b, "configs", "client_probe.json")) as f:
        cfg = json.load(f)
    assert cfg["camera"]["width"] == 80 and cfg["mapper"]["max_submaps"] == 4
    assert cfg["probe"] == {"budget": 8}           # the new driver's cut
    assert cfg["extra"] == {"max_submaps": 99}     # a section none cuts
    with open(os.path.join(b, "traffic", "probe.json")) as f:
        assert json.load(f)["window_frames"] == 10

    # two runs at a time: more would slow the open-loop serve cell that
    # other test workers run beside this one
    with ThreadPoolExecutor(2) as pool:
        flat = pool.submit(tiny.run, root, "client_flat.stream", trace=1)
        probe = pool.submit(tiny.run, root, new, trace=1)
        control = pool.submit(tiny.control, root, new)
        faulty = {f: pool.submit(tiny.run, root, new, seed=13, patch=p)
                  for f, p in tiny.faults(b)[new].items()}
        rc, line, err = flat.result()
        assert rc == 0, err[-3000:]
        assert line["correct"]
        m = line["metrics"]
        assert m["frames_traced.device_ms_per_frame"]["value"] > 0
        # a metric of another end-to-end metric stays out of this cell
        assert not any(n.endswith(".device_ms_per_optimize") for n in m)
        # readers of the program's spans find nothing with tracing off
        assert not set(PROBE_READERS) & set(m)

        rc, line, err = probe.result()
        assert rc == 0, err[-3000:]
        assert line["correct"], line["checks"]
        m = line["metrics"]
        # one allocation span a frame, every frame counted by the port
        assert m["alloc_spans_per_frame.device_ms_per_frame"]["value"] == 1.0
        assert m["frames_counted.device_ms_per_frame"]["value"] == 1.0
        assert m["frames_traced.device_ms_per_frame"]["value"] > 0
        checks = control.result()
        assert any(v > lim for _, v, lim in checks), checks
        for f, fut in faulty.items():
            rc, line, err = fut.result()
            assert rc == 0, err[-3000:]
            assert not line["correct"], (f, line["checks"])


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
