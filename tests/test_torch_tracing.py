"""Program tracing of the port: ``runtime.span``, ``runtime.count``,
``runtime.tracing`` and ``runtime.snapshot``, and the spans and counters
at the layer boundaries of the mapper, the server's solve and the
serving path.

Off (the default), a span is one shared no-op context and enters no
``record_function``; on, each span is a ``cox.``-named range in a
``torch.profiler`` trace, nested as the code nests, and the snapshot's
counts match. Tracing changes no result: ``HostMapper.step_batch``,
``HostMapper.live_mesh``, ``esdf_from_tsdf`` and
``CoxgraphServer.optimize`` are bit-identical with it on and off, and no
span or counter reads a tensor back. This file imports no JAX, so the
case marked ``cuda`` runs on a card:

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda -q
"""

import dataclasses
import math
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.eval import demos
from coxgraph_tpu_torch.frontends import loop_detector as ld
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import esdf as esdf_ops
from coxgraph_tpu_torch.ops import features as ft
from coxgraph_tpu_torch.server import fusion_server as fs

CPU = torch.device("cpu")
FRAMES = 6
# the tensor methods that read a value back to the host
READBACKS = ("item", "cpu", "tolist", "numpy", "__int__", "__float__",
             "__bool__", "__index__")


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread during each test (the suite runs in several
    processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Program tracing on for the test, off after it."""
    runtime.tracing(True)
    yield
    runtime.tracing(False)


def _clip(device):
    """FRAMES frames of the small world's mapper (80×60, 8³ blocks), host
    poses, timestamps crossing one submap rollover."""
    cfg, _ = demos.small_world_configs()
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(FRAMES, scene.room_center, radius=2.3,
                                sweep=0.4 * np.pi)
    frames = [syn.render_depth(scene, cfg.intrinsics, traj[i])
              for i in range(FRAMES)]
    depths = torch.stack([f[0] for f in frames])
    colors = torch.stack([f[1] for f in frames])
    ts = np.arange(FRAMES, dtype=np.float64) * 0.05
    return cfg, depths, colors, traj.cpu().numpy(), ts


def _map(device, clip=None):
    """A HostMapper over the clip in two step_batch windows, then the
    live mesh of every submap and the ESDF of the first → (mapper,
    [(verts, colors)], esdf)."""
    cfg, depths, colors, poses, ts = clip or _clip(device)
    hm = sm.HostMapper(cfg, device=device)
    h = FRAMES // 2
    hm.step_batch(depths[:h], colors[:h], poses[:h], ts[:h])
    hm.step_batch(depths[h:], colors[h:], poses[h:], ts[h:])
    meshes = [hm.live_mesh(k) for k in range(hm.n_submaps)]
    e = esdf_ops.esdf_from_tsdf(
        cfg.spec, sm.get_layer(hm.state.collection.layers, 0),
        esdf_ops.EsdfConfig(max_distance=0.5))
    return hm, meshes, e


def _tensors(x, prefix=""):
    """{path: tensor} of every tensor field under a dataclass."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_tensors(v, prefix + f.name + "."))
    return out


def _counter_delta(before, after):
    return {k: v - before["counters"].get(k, 0)
            for k, v in after["counters"].items()
            if v != before["counters"].get(k, 0)}


def _span_delta(before, after):
    return {k: v["n"] - before["spans"].get(k, {"n": 0})["n"]
            for k, v in after["spans"].items()
            if v["n"] != before["spans"].get(k, {"n": 0})["n"]}


# ---------------------------------------------------------------------------
# The facility
# ---------------------------------------------------------------------------


def test_off_is_one_shared_noop_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    runtime.tracing(False)
    assert runtime.span("a") is runtime.span("b")
    before = runtime.snapshot()
    with runtime.span("a"):
        with runtime.span("b"):
            pass
    runtime.count("c", 5)
    _map(CPU)
    assert runtime.snapshot() == before


def test_nested_spans_in_a_profiler_trace_and_the_snapshot(traced):
    before = runtime.snapshot()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with runtime.span("outer"):
            for _ in range(3):
                with runtime.span("inner"):
                    torch.ones(4).add_(1)
    runtime.count("things", 2)
    runtime.count("things")
    after = runtime.snapshot()
    ev = [e for e in prof.events() if e.name.startswith("cox.")]
    outer = [e for e in ev if e.name == "cox.outer"]
    inner = [e for e in ev if e.name == "cox.inner"]
    assert len(outer) == 1 and len(inner) == 3
    assert all(e.cpu_parent is outer[0] for e in inner)
    assert _span_delta(before, after) == {"outer": 1, "inner": 3}
    assert _counter_delta(before, after) == {"things": 3}
    # the outer span's host time holds the inner spans'
    t = {k: after["spans"][k]["total_s"]
         - before["spans"].get(k, {"total_s": 0.0})["total_s"]
         for k in ("outer", "inner")}
    assert t["outer"] >= t["inner"] > 0
    assert {"k1.launches", "k2.launches"} <= set(after["counters"])


def test_mapper_and_serving_spans_nest_and_count(traced):
    clip = _clip(CPU)
    before = runtime.snapshot()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        hm, meshes, _ = _map(CPU, clip)
    after = runtime.snapshot()
    spans = _span_delta(before, after)
    assert spans["mapper.step_batch"] == 2
    assert spans["tsdf.alloc"] == spans["tsdf.update_blocks"] == FRAMES
    assert spans["mapper.rollover_plan"] == spans["mapper.upload"] == 2
    assert spans["mapper.start_submap"] == hm.n_submaps == 2
    assert spans["mapper.mirror"] >= 2 and spans["mapper.stats"] >= 2
    assert spans["serve.consume_dirty"] == spans["mesh.dirty_chunks"] == 2
    assert spans["mesh.extract"] >= 2 and spans["esdf.build"] == 1
    assert spans["mesh.host_triangles"] == spans["mesh.cache"] == 2
    counters = _counter_delta(before, after)
    assert counters["mapper.frames"] == FRAMES
    assert counters["mapper.rollovers"] == 2
    sweeps = math.ceil(0.5 / clip[0].spec.voxel_size) + 4
    assert counters["esdf.sweeps"] == sweeps
    remeshed = sum(hm._meshers[k].chunks_remeshed for k in hm._meshers)
    assert counters["mesh.chunks_remeshed"] == remeshed > 0
    assert counters.get("mesh.retries", 0) == sum(
        m.buffer_growths + m.capacity_growths for m in hm._meshers.values())
    assert all(type(v) is int for v in after["counters"].values())

    def cox_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("cox."):
            p = p.cpu_parent
        return p.name if p is not None else None

    parents = {}
    for e in prof.events():
        if e.name.startswith("cox."):
            parents.setdefault(e.name, set()).add(cox_parent(e))
    assert parents["cox.tsdf.alloc"] == {"cox.mapper.step_batch"}
    assert parents["cox.tsdf.update_blocks"] == {"cox.mapper.step_batch"}
    assert parents["cox.mapper.rollover_plan"] == {"cox.mapper.step_batch"}
    assert parents["cox.mapper.step_batch"] == {None}
    assert parents["cox.mesh.extract"] == {None}
    assert parents["cox.esdf.build"] == {None}


@pytest.mark.parametrize("full", [False, True])
def test_cpu_esdf_build_runs_the_plain_sweeps(traced, monkeypatch, full):
    """On the CPU esdf_from_tsdf is the plain sweeps, bit for bit, inside
    one esdf.build span: no kernel is built or launched (esdf.launches
    unchanged) and esdf.sweeps counts ceil(max_distance / voxel) + extra
    sweeps."""
    from coxgraph_tpu_torch import _build

    def refuse():
        raise AssertionError("a CPU build loaded the kernels")

    monkeypatch.setattr(_build, "load", refuse)
    cfg, _ = demos.small_world_configs()
    hm, _, _ = _map(CPU)
    layer = sm.get_layer(hm.state.collection.layers, 0)
    ecfg = esdf_ops.EsdfConfig(max_distance=0.4, full_connectivity=full)
    before = runtime.snapshot()
    e = esdf_ops.esdf_from_tsdf(cfg.spec, layer, ecfg)
    after = runtime.snapshot()
    plain = esdf_ops._esdf_sweeps(cfg.spec, layer, ecfg)
    assert torch.equal(e.dist.view(torch.int32), plain.dist.view(torch.int32))
    assert torch.equal(e.observed, plain.observed)
    assert _span_delta(before, after) == {"esdf.build": 1}
    sweeps = math.ceil(0.4 / cfg.spec.voxel_size) + 4
    assert _counter_delta(before, after) == {"esdf.sweeps": sweeps}
    assert after["counters"]["esdf.launches"] \
        == before["counters"]["esdf.launches"]


def test_threads_add_every_span_and_count(traced):
    before = runtime.snapshot()

    def work():
        for _ in range(500):
            with runtime.span("thread.work"):
                runtime.count("thread.items")

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = runtime.snapshot()
    assert _span_delta(before, after) == {"thread.work": 4000}
    assert _counter_delta(before, after) == {"thread.items": 4000}


DETECT_SPANS = ("detect.ingest", "detect.features", "detect.eligibility",
                "detect.match", "detect.verify", "detect.read",
                "detect.append")


def _detector_batches():
    """A 4-slot CPU detector at 40x30 and two sub-batches of 4 noise
    frames from two robots, the second 10 s after the first."""
    intr = syn.PinholeIntrinsics().scaled(1 / 16)
    cfg = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=16, border=4,
                                  ransac_iters=8),
        keyframe_stride=0.0, max_keyframes=4, match_chunk=2)
    g = torch.Generator().manual_seed(5)
    H, W = intr.height, intr.width

    def batch(t0):
        return [(i % 2, t0 + i // 2, torch.rand(H, W, 3, generator=g),
                 1.0 + torch.rand(H, W, generator=g)) for i in range(4)]

    return ld.LoopDetector(intr, cfg, device=CPU), batch(0.0), batch(10.0)


def test_detector_spans_and_counters(traced):
    """One sub-batch against a full pool opens each detect.* span once
    (its description, then its ingest holding the other stages) and counts
    its keyframes, evictions, candidates and closures; with tracing off
    nothing is recorded."""
    det, first, second = _detector_batches()
    runtime.tracing(False)
    before = runtime.snapshot()
    det.add_keyframes_batch(first)
    assert runtime.snapshot() == before
    assert det.n_keyframes == 4 and det.dropped_keyframes == 0
    runtime.tracing(True)
    before = runtime.snapshot()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        msgs = det.add_keyframes_batch(second)
    after = runtime.snapshot()
    assert _span_delta(before, after) == {n: 1 for n in DETECT_SPANS}
    counters = _counter_delta(before, after)
    assert counters.pop("detect.closures", 0) == len(msgs)
    # every member of the sub-batch evicts: the pool was full
    assert det.dropped_keyframes == 4
    assert counters == {"detect.keyframes": 4,
                        "detect.evictions": det.dropped_keyframes,
                        "detect.candidates": 4 * det.cfg.max_candidates}
    parents = {e.name: e.cpu_parent and e.cpu_parent.name
               for e in prof.events() if e.name.startswith("cox.detect.")}
    assert parents == dict(
        {"cox.detect.ingest": None, "cox.detect.features": None},
        **{"cox." + n: "cox.detect.ingest" for n in DETECT_SPANS[2:]})


# ---------------------------------------------------------------------------
# Tracing changes no result and reads nothing back
# ---------------------------------------------------------------------------


def test_mapper_and_serving_bit_identical_on_and_off():
    clip = _clip(CPU)
    runtime.tracing(False)
    off = _map(CPU, clip)
    runtime.tracing(True)
    try:
        on = _map(CPU, clip)
    finally:
        runtime.tracing(False)
    a, b = _tensors(off[0].state), _tensors(on[0].state)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert len(off[1]) == len(on[1]) == 2
    for (va, ca), (vb, cb) in zip(off[1], on[1]):
        assert va.shape[0] > 0
        assert np.array_equal(va, vb) and np.array_equal(ca, cb)
    assert torch.equal(off[2].dist, on[2].dist)
    assert torch.equal(off[2].observed, on[2].observed)


def _server():
    """The small two-client world's server after two true fusions (each
    runs an optimize)."""
    trajs, _, clients = demos.small_two_client_world(CPU, 0.3)
    _, scfg = demos.small_world_configs()
    server = fs.CoxgraphServer(scfg, clients, CPU)
    for ta, tb in ((3, 3), (6, 5)):
        assert server.map_fusion(demos.true_fusion(trajs, ta, tb))
    return server


def test_server_optimize_bit_identical_on_and_off():
    runtime.tracing(False)
    off = _server()
    runtime.tracing(True)
    try:
        before = runtime.snapshot()
        on = _server()
        info = on.optimize()
        after = runtime.snapshot()
    finally:
        runtime.tracing(False)
    off_info = off.optimize()
    for s_off, s_on in zip(off.submaps, on.submaps):
        assert np.array_equal(s_off.T_G_submap, s_on.T_G_submap)
    for c in off.T_G_cli:
        assert np.array_equal(off.T_G_cli[c], on.T_G_cli[c])
    assert off_info["phase2_cost_trace"] == info["phase2_cost_trace"]
    assert off_info["phase1_cost"] == info["phase1_cost"]
    spans = _span_delta(before, after)
    n_opt = spans["server.optimize"]
    assert n_opt >= 3
    for name in ("server.snapshot", "server.readback", "server.align",
                 "server.push", "opt.phase1", "opt.pairs", "opt.phase2",
                 "opt.phase2_tail"):
        assert spans[name] == n_opt, name
    counters = _counter_delta(before, after)
    pairs = sum(x["n_registration_pairs"] for x in on.fusion_log)
    assert counters["opt.registration_pairs"] == pairs > 0
    assert counters["opt.phase2_iterations"] == 6 * n_opt
    assert 1 <= counters["opt.stack_misses"] == spans["opt.stack"] <= n_opt


def _count_readbacks(monkeypatch):
    """Wrap every tensor readback method with a counter → the counts."""
    calls = {"n": 0}
    for name in READBACKS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            calls["n"] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return calls


def test_spans_and_counters_read_no_tensor(monkeypatch):
    clip = _clip(CPU)
    calls = _count_readbacks(monkeypatch)
    runtime.tracing(False)
    _map(CPU, clip)
    off = calls["n"]
    calls["n"] = 0
    runtime.tracing(True)
    try:
        _map(CPU, clip)
    finally:
        runtime.tracing(False)
    assert off > 0 and calls["n"] == off


@pytest.mark.cuda
def test_step_batch_syncs_equal_with_tracing_on(monkeypatch):
    """Host syncs over a step_batch window, counted under CUDA's sync
    debug mode, read the same with program tracing on as off (0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sync debug mode is CUDA's)")
    from coxgraph_tpu_torch import _build

    _build.load()
    gpu = torch.device("cuda", 0)
    cfg, depths, colors, poses, ts = _clip(gpu)

    def syncs(on: bool) -> int:
        hm = sm.HostMapper(cfg, device=gpu)
        hm.step_batch(depths, colors, poses, ts)        # warm
        runtime.tracing(on)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                hm.step_batch(depths, colors, poses, ts + 1.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            runtime.tracing(False)
        return sum("synchroniz" in str(w.message) for w in caught)

    assert syncs(False) == syncs(True) == 0


# ---------------------------------------------------------------------------
# tools/profile_torch_spans.py: a trace read by program span
# ---------------------------------------------------------------------------


def _spans_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "profile_torch_spans.py")
    spec = importlib.util.spec_from_file_location("profile_torch_spans",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_breakdown_by_program_span():
    """A hand-made trace: span a holds span b; one launch inside b, one
    outside both; the device-side annotations of span a and of the
    stretch are no work."""
    p = _spans_tool()
    E = p.Event
    events = [
        E(p.MARK, False, 0, 100, 1, 0, 0),
        E("slambench.step", False, 0, 100, 1, 0, 0),
        E("cox.a", False, 10, 60, 1, 0, 0),
        E("cox.b", False, 20, 30, 1, 0, 0),
        E("cudaLaunchKernel", False, 22, 23, 1, 5, 0),
        E("cudaLaunchKernel", False, 70, 71, 1, 6, 0),
        E("kernel_one", True, 40, 50, 7, 5, 0),
        E("kernel_two", True, 80, 90, 7, 6, 0),
        E("cox.a", True, 40, 90, 7, 0, 0),          # annotations
        E(p.MARK, True, 30, 95, 7, 0, 0),
    ]
    r = p.breakdown(events)
    ns = 1e-9
    assert r["busy_s"] == pytest.approx(20 * ns)
    assert r["busy_with_annotations_s"] == pytest.approx(50 * ns)
    assert r["idle_s"] == pytest.approx(80 * ns)
    assert r["launches"] == 2 and r["unlinked_device_s"] == 0.0
    a, b, none = r["spans"]["a"], r["spans"]["b"], r["spans"][p.NONE]
    assert (a["n"], b["n"], none["n"]) == (1, 1, 0)
    assert a["host_s"] == pytest.approx(50 * ns)
    assert a["self_host_s"] == pytest.approx(40 * ns)
    assert b["self_host_s"] == pytest.approx(10 * ns)
    assert (a["launches"], b["launches"], none["launches"]) == (1, 1, 1)
    assert a["device_s"] == b["device_s"] == pytest.approx(10 * ns)
    assert none["device_s"] == pytest.approx(10 * ns)
    # idle: [0,40) → none 10, a 20, b 10; [50,80) → a 10, none 20;
    # [90,100) → none 10
    assert a["idle_s"] == pytest.approx(30 * ns)
    assert b["idle_s"] == pytest.approx(10 * ns)
    assert none["idle_s"] == pytest.approx(40 * ns)
    assert r["idle_gaps"][0] == ["step/b/host", pytest.approx(40 * ns)]
    step = r["driver"]["step"]
    assert step["n"] == 1 and step["wall_s"] == pytest.approx(100 * ns)
    assert step["idle_s"] == pytest.approx(80 * ns)
    assert step["idle_in_spans_s"] == pytest.approx(40 * ns)
    assert r["idle_gaps"][1][0] == "step/host"
