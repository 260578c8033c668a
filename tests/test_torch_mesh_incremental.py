"""coxgraph_tpu_torch.ops.mesh_incremental and the mapper's live meshing vs
coxgraph_tpu, on the sphere layer of tests/test_mesh.py and the 8³-block
mapper of tests/test_mesh_incremental.py (80×60 frames).

Tolerances: integers exact (chunk ids re-meshed, counters, triangle
counts); the port's incremental mesh equals its own full extraction
exactly (np.array_equal); against the JAX package on the same layer, the
same triangles in the same order within atol 1e-5 (observed max |Δ|
6e-8). Meshes of maps that each side integrated itself inherit the
integration's tolerance (tests/test_torch_mapper.py: a voxel whose pixel
sits on a rounding boundary samples the neighbouring pixel): the same
triangle count and order, the share of values off by more than 1e-5
below 1e-3 and none off by more than 5e-3 (observed: 7 of 450,396
vertex values, max 4.7e-4)."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import mesh as jmesh
from coxgraph_tpu.ops.mesh_incremental import IncrementalMesher as JMesher
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.eval import benchmarks as bm
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import mesh as pmesh
from coxgraph_tpu_torch.ops.mesh_incremental import IncrementalMesher
from coxgraph_tpu_torch.utils import interop
from test_mesh_incremental import _mapper_cfg
from test_torch_mesh import SPEC, JSPEC, dense, one_thread, sphere  # noqa: F401

CPU = torch.device("cpu")
JCFG = _mapper_cfg()
CFG = interop.config_from(JCFG)


def _same(a, b, atol=1e-5):
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_full_rebuild_equals_extract_mesh_exactly():
    jl, pl = sphere()
    m = IncrementalMesher(SPEC, chunk=16, quantize=False)
    m.full_rebuild(pl)
    v, c = m.mesh()
    v_full, c_full = pmesh.extract_mesh(SPEC, pl, chunk=16, quantize=False)
    assert v.shape[0] > 1000
    assert np.array_equal(v, v_full) and np.array_equal(c, c_full)
    assert m.n_triangles == v.shape[0]
    assert m.chunks_remeshed == -(-SPEC.max_blocks // 16)


@pytest.mark.parametrize("quantize", [False, True])
def test_one_block_update_remeshes_o1_blocks(quantize):
    """One changed block re-meshes its ≤ 8 dependants (the JAX package's
    dirty set) and the mesh equals full extraction (to one quantum when
    quantized)."""
    jl, pl = sphere()
    m = IncrementalMesher(SPEC, chunk=1, quantize=quantize)
    m.full_rebuild(pl)
    slot = int(pl.num_blocks) // 2
    jl2 = dataclasses.replace(jl, sdf=jl.sdf.at[slot].add(0.05))
    pl2 = dataclasses.replace(pl, sdf=pl.sdf.clone())
    pl2.sdf[slot] += 0.05
    dirty = np.zeros((JSPEC.max_blocks,), bool)
    dirty[slot] = True
    ids = m.update(pl2, torch.from_numpy(dirty))
    want = np.nonzero(np.asarray(jmesh.dirty_block_chunks(
        JSPEC, jl2, jnp.asarray(dirty), 1)))[0].tolist()
    assert ids == want and 1 <= len(ids) <= 8
    v_full, _ = pmesh.extract_mesh(SPEC, pl2, chunk=1, quantize=False)
    if quantize:
        assert np.abs(m.mesh()[0] - v_full).max() < 1e-4
    else:
        assert np.array_equal(m.mesh()[0], v_full)


def test_vanished_geometry_clears_cached_chunks():
    _, pl = sphere()
    m = IncrementalMesher(SPEC, chunk=1, quantize=False)
    m.full_rebuild(pl)
    assert m.n_triangles > 0
    gone = dataclasses.replace(pl, weight=torch.zeros_like(pl.weight))
    m.update(gone, torch.arange(SPEC.max_blocks) < int(pl.num_blocks))
    assert m.n_triangles == 0 and m.mesh()[0].shape == (0, 3, 3)


@pytest.mark.parametrize("case", ["buffer", "capacity"])
def test_capacity_self_heal(case):
    """A full buffer (max_tris=256) grows and a dense chunk escalates
    cap_mult, silently, and the mesh comes out complete; the dense case
    ends at the JAX mesher's counters."""
    jl, pl = sphere() if case == "buffer" else dense()
    kw = dict(chunk=16, quantize=False)
    if case == "buffer":
        kw["max_tris"] = 256
    m = IncrementalMesher(SPEC, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m.full_rebuild(pl)
    assert (m.buffer_growths if case == "buffer" else m.capacity_growths) >= 1
    v_full, _ = pmesh.extract_mesh(SPEC, pl, chunk=16, quantize=False)
    assert np.array_equal(m.mesh()[0], v_full)
    if case == "capacity":
        jm = JMesher(JSPEC, **kw)
        jm.full_rebuild(jl)
        for name in ("max_tris", "cap_mult", "buffer_growths",
                     "capacity_growths", "dropped_tris", "chunks_remeshed"):
            assert getattr(m, name) == getattr(jm, name), name
        _same(m.mesh()[0], jm.mesh()[0])


def _same_integrated(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert (d > 1e-5).mean() < 1e-3 and d.max() <= 5e-3, d.max()


def _clip(n, sweep=0.06 * np.pi):
    scene = jsyn.default_scene()
    traj = jsyn.orbit_trajectory(n, scene.room_center, radius=2.5,
                                 sweep=sweep)
    fr = [jsyn.render_depth(scene, JCFG.intrinsics, traj[i])
          for i in range(n)]
    return ([np.asarray(f[0]) for f in fr], [np.asarray(f[1]) for f in fr],
            np.asarray(traj))


def _full(mapper, k=0):
    layer = sm.get_layer(mapper.state.collection.layers, k)
    return pmesh.extract_mesh(CFG.spec, layer, chunk=16, quantize=False)


def test_live_mesh_streams_like_jax():
    """step → live_mesh, twice, then a no-op live_mesh: the same chunks
    re-meshed as the JAX mapper, and the port's mesh equals its full
    extraction exactly after every call."""
    ds, cs, traj = _clip(2)
    jmap, pmap = jsm.HostMapper(JCFG), sm.HostMapper(CFG, device=CPU)
    for i in range(2):
        jmap.step(ds[i], cs[i], traj[i], 0.1 * i)
        pmap.step(ds[i], cs[i], traj[i], 0.1 * i)
        vj, cj = jmap.live_mesh(quantize=False)
        vp, cp = pmap.live_mesh(quantize=False)
        assert (pmap.live_mesher(0).chunks_remeshed
                == jmap.live_mesher(0).chunks_remeshed)
        v_full, c_full = _full(pmap)
        assert vp.shape[0] > 0
        assert np.array_equal(vp, v_full) and np.array_equal(cp, c_full)
        _same_integrated(vp, vj)
        _same_integrated(cp, cj)
    before = pmap.live_mesher(0).chunks_remeshed
    v3, _ = pmap.live_mesh(quantize=False)
    assert pmap.live_mesher(0).chunks_remeshed == before
    assert np.array_equal(v3, vp)


def test_live_mesh_async_meshes_the_geometry_of_dispatch():
    """finish() after an in-place step_batch returns the mesh of the layer
    as it was at dispatch (get_layer copies)."""
    ds, cs, traj = _clip(3)
    ref = sm.HostMapper(CFG, device=CPU)
    ref.step(ds[0], cs[0], traj[0], 0.0)
    v_ref, c_ref = ref.live_mesh(quantize=False)
    m = sm.HostMapper(CFG, device=CPU)
    m.step(ds[0], cs[0], traj[0], 0.0)
    finish = m.live_mesh_async(quantize=False)
    m.step_batch(np.stack(ds[1:]), np.stack(cs[1:]), traj[1:], [0.1, 0.2])
    v, c = finish()
    assert np.array_equal(v, v_ref) and np.array_equal(c, c_ref)
    v2, _ = m.live_mesh(quantize=False)
    assert np.array_equal(v2, _full(m)[0])


def test_dropped_finish_loses_no_update():
    """The repair of the reference's fault at
    coxgraph_tpu/mapper/submap_mapper.py:664, where live_mesh_async
    consumes the dirty bits at dispatch and a finish() that never runs
    loses them: here the consumed row stays pending on the mesher and the
    next dispatch ORs it in. Dispatch, drop finish(), step, then live_mesh
    equals full extraction; live_mesh_odom sees the submap as not clean."""
    ds, cs, traj = _clip(3, sweep=0.5 * np.pi)
    m = sm.HostMapper(CFG, device=CPU)
    m.step(ds[0], cs[0], traj[0], 0.0)
    m.live_mesh(quantize=False)
    m.step(ds[1], cs[1], traj[1], 0.1)
    m.live_mesh_async(quantize=False)                # finish() dropped
    assert m.live_mesher(0).pending is not None
    v_odom, _ = m.live_mesh_odom()                   # must re-mesh
    assert m.live_mesher(0).pending is None
    assert v_odom.shape == _full(m)[0].shape
    m.live_mesh_async(quantize=False)                # dropped again
    m.step(ds[2], cs[2], traj[2], 0.2)
    v, c = m.live_mesh(quantize=False)
    v_full, c_full = _full(m)
    assert np.array_equal(v, v_full) and np.array_equal(c, c_full)
    assert m.live_mesher(0).pending is None


def test_live_mesh_odom():
    """Three submaps (0.3 s interval): the odom-frame soup is each
    submap's full extraction posed by T_odom_submap, in submap order; a
    second call re-meshes nothing, and a moved pose re-poses the cache."""
    cfg = dataclasses.replace(CFG, submap_interval=0.3)
    ds, cs, traj = _clip(5, sweep=0.3 * np.pi)
    pmap = sm.HostMapper(cfg, device=CPU)
    pmap.step_batch(np.stack(ds), np.stack(cs), traj, np.arange(5) * 0.15)
    assert pmap.n_submaps == 3

    def posed():
        poses = pmap.state.collection.T_odom_submap.numpy()
        parts = [_full(pmap, k) for k in range(3)]
        return (np.concatenate([geo.transform_points_np(
            poses[k], v.reshape(-1, 3)).reshape(-1, 3, 3)
            for k, (v, _) in enumerate(parts)]),
            np.concatenate([c for _, c in parts]))

    vp, cp = pmap.live_mesh_odom(quantize=False)
    vw, cw = posed()
    assert vp.shape[0] > 0
    assert np.array_equal(vp, vw) and np.array_equal(cp, cw)
    n = sum(m.chunks_remeshed for m in pmap._meshers.values())
    v2, _ = pmap.live_mesh_odom()
    assert sum(m.chunks_remeshed for m in pmap._meshers.values()) == n
    assert np.array_equal(v2, vp)
    pmap.state.collection.T_odom_submap[1, 4] += 0.5
    v3, _ = pmap.live_mesh_odom()
    assert sum(m.chunks_remeshed for m in pmap._meshers.values()) == n
    assert np.array_equal(v3, posed()[0])


def test_live_mesher_settings_are_fixed():
    m = sm.HostMapper(CFG, device=CPU)
    m.live_mesher(0, quantize=False, chunk=16)
    assert m.live_mesher(0, max_tris=10) is m.live_mesher(0)
    with pytest.raises(ValueError):
        m.live_mesher(0, quantize=True)
    with pytest.raises(TypeError):
        m.live_mesher(0, colour=True)


@pytest.mark.parametrize("bad", [{"quantize": True}, {"colour": True}],
                         ids=["conflicting", "unknown"])
def test_refused_dispatch_consumes_nothing(bad):
    """A live_mesh_async whose kwargs the mesher refuses raises before it
    consumes the dirty bits: the next live_mesh still equals full
    extraction."""
    ds, cs, traj = _clip(2, sweep=0.5 * np.pi)
    m = sm.HostMapper(CFG, device=CPU)
    m.step(ds[0], cs[0], traj[0], 0.0)
    m.live_mesh(quantize=False)
    m.step(ds[1], cs[1], traj[1], 0.1)
    with pytest.raises(ValueError if "quantize" in bad else TypeError):
        m.live_mesh_async(**bad)
    v, c = m.live_mesh()
    v_full, c_full = _full(m)
    assert np.array_equal(v, v_full) and np.array_equal(c, c_full)


def test_stage_benchmark_keys_on_a_small_map(monkeypatch):
    """stage_benchmark end to end on the CPU at the 80×60 mapper (counts
    only; its times mean nothing here)."""
    monkeypatch.setattr(bm, "_mapper_config", lambda: CFG)
    ds, cs, traj = _clip(4)
    out = bm.stage_benchmark(torch.from_numpy(np.stack(ds)),
                             torch.from_numpy(np.stack(cs)),
                             torch.from_numpy(traj))
    assert set(out) == {
        "union_watermark", "dropped_union_blocks", "esdf_ms", "esdf_blocks",
        "mesh_extract_ms", "mesh_tris", "merge_ms",
        "serve_while_streaming_fps", "serve_live_mesh_tris"}
    assert out["dropped_union_blocks"] == 0 and out["esdf_blocks"] > 0
    assert out["mesh_tris"] > 0 and out["serve_live_mesh_tris"] > 0
    assert all(np.isfinite(v) and v >= 0 for v in out.values())
