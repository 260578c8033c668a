"""bench_torch.py, the port's root bench entry, on the CPU at the 80×60
mapper of tests/test_mesh_incremental.py (its times mean nothing here;
the keys, counts and the CPU baseline's cache do).

The JSON line is held to bench.py's keys (bench.py:245-266): the four
top-level keys and ``extra_metrics``, which holds stage_benchmark's nine
keys (coxgraph_tpu/eval/benchmarks.py's ``stage_benchmark``) and the
solve's four (bench.py:252-263). The solve, cut to 8 submaps, counts
exactly as many registration pairs as the JAX two-phase optimize on the
JAX package's solve_benchmark_problem(8)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from coxgraph_tpu.eval import benchmarks as jbm
from coxgraph_tpu.server import global_opt as jgo
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.eval import benchmarks as bm
from test_torch_mesh import one_thread  # noqa: F401
from test_torch_mesh_incremental import CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FRAMES = 4
STAGE_KEYS = {
    "union_watermark", "dropped_union_blocks", "esdf_ms", "esdf_blocks",
    "mesh_extract_ms", "mesh_tris", "merge_ms", "serve_while_streaming_fps",
    "serve_live_mesh_tris"}
SOLVE_KEYS = {"two_phase_optimize_s", "two_phase_optimize_best_s",
              "solve_submaps", "solve_pairs"}


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def bt(monkeypatch):
    """bench_torch at the 80×60 mapper."""
    monkeypatch.setattr(bm, "_mapper_config", lambda: CFG)
    return _load_bench()


def _jax_pairs(n):
    """The JAX two-phase optimize's ``n_registration_pairs`` on its
    solve_benchmark_problem(n), counted as it counts them (phase 1, then
    the overlapping pairs, then their registration pairs;
    coxgraph_tpu/server/global_opt.py:410-429) without phase 2."""
    init, cons, layers, spec, rcfg, scfg, fixed = \
        jbm.solve_benchmark_problem(n)
    poses = jpg.optimize(init, cons, scfg, fixed=fixed).poses
    pairs = jgo.find_overlapping_pairs(spec, layers, poses)
    return len(jgo.make_registration_pairs(spec, layers, pairs, rcfg))


def test_run_prints_bench_line_on_the_cpu(bt, monkeypatch, capsys,
                                          tmp_path):
    """run(device=cpu): one JSON line, last on stdout, with exactly
    bench.py's keys; finite non-negative values; the 8-submap solve's
    pairs equal JAX's; vs_baseline is the headline over the cached CPU
    reading."""
    full_problem = bm.solve_benchmark_problem
    monkeypatch.setattr(bm, "solve_benchmark_problem",
                        lambda device=None: full_problem(8, device=device))
    cache = tmp_path / "baseline.json"
    cache.write_text(json.dumps(dict(bt.cpu_machine(), clip=FRAMES,
                                     fps=2.0)))

    res = bt.run(CPU, frames=FRAMES, cache=str(cache))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == res
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "extra_metrics"}
    assert line["metric"] == "tsdf_integration_fps"
    assert line["unit"] == "frames/s/chip"
    extra = line["extra_metrics"]
    assert set(extra) == STAGE_KEYS | SOLVE_KEYS
    values = [line["value"], line["vs_baseline"], *extra.values()]
    assert all(np.isfinite(v) and v >= 0 for v in values), line
    assert line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 2.0) <= 0.01
    assert extra["dropped_union_blocks"] == 0 and extra["mesh_tris"] > 0
    assert extra["solve_submaps"] == 8
    assert extra["solve_pairs"] == _jax_pairs(8)
    assert "cached in baseline.json" in err
    assert "vs_baseline = " in err


def test_no_gpu_exits_nonzero_without_a_line():
    """``python bench_torch.py`` on a machine without CUDA: nonzero exit,
    require_cuda's message on stderr, no JSON on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: this would run the full bench")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "a CUDA GPU is required" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("stale", [None, "missing", "cpu", "threads",
                                   "torch", "clip"])
def test_cpu_baseline_cache(bt, tmp_path, stale):
    """The cached CPU reading is measured again when the file is missing
    or its CPU model, thread count, torch version or clip length differs
    from this machine's, and is read back otherwise."""
    calls = []

    def measure(frames):
        calls.append(frames)
        return bt.measure_cpu_fps(frames)

    path = tmp_path / "baseline.json"
    rec = dict(bt.cpu_machine(), clip=FRAMES, fps=123.0)
    if stale == "threads":
        rec["threads"] += 1
    elif stale == "clip":
        rec["clip"] += 1
    elif stale in ("cpu", "torch"):
        rec[stale] = "another " + str(rec[stale])
    if stale != "missing":
        path.write_text(json.dumps(rec))

    got = bt.cpu_baseline(FRAMES, str(path), measure=measure)
    if stale is None:
        assert calls == [] and got["cached"] and got["fps"] == 123.0
        return
    assert calls == [FRAMES] and not got["cached"]
    assert np.isfinite(got["fps"]) and got["fps"] > 0
    assert json.loads(path.read_text()) == dict(
        bt.cpu_machine(), clip=FRAMES, fps=got["fps"])
    again = bt.cpu_baseline(FRAMES, str(path), measure=measure)
    assert calls == [FRAMES] and again["cached"]
    assert again["fps"] == got["fps"]


def test_cpu_baseline_renders_the_clips_first_frames(bt):
    """generate_frames(render=k), as the CPU baseline calls it: the first
    k frames of the full clip, bit for bit."""
    full = bm.generate_frames(CPU, 10)
    first = bm.generate_frames(CPU, 10, render=bt.CPU_FRAMES)
    for a, b in zip(full, first):
        assert b.shape[0] == bt.CPU_FRAMES
        assert torch.equal(a[:bt.CPU_FRAMES], b)
