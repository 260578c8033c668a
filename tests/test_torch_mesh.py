"""coxgraph_tpu_torch.ops.mesh vs coxgraph_tpu.ops.mesh on the sphere layer
of tests/test_mesh.py (8³ blocks, 0.1 m voxels) with seeded colours, and
on a pathologically dense (checkerboard) layer.

Tolerances: integers exact (tet table, per-chunk counts and totals,
dirty chunks, chunk offsets, triangle counts); the same triangles in the
same order, vertices and colours within atol 1e-5 on the f32 path
(observed max |Δ| 6e-8: XLA fuses multiply-adds the port keeps apart);
the quantized path equal up to one quantum (observed: equal)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.ops import mesh as jmesh
from coxgraph_tpu_torch.ops import mesh as pmesh
from coxgraph_tpu_torch.utils import interop
from test_mesh import SPEC as JSPEC, make_sphere_layer

SPEC = interop.config_from(JSPEC)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread during each test: the suite runs in several
    processes at once, and a full intra-op pool in each oversubscribes the
    cores (these tests ran 50-150× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jl):
    """The JAX layer and its port copy."""
    arr = {f.name: np.asarray(getattr(jl, f.name))
           for f in dataclasses.fields(jl)}
    return jl, interop.layer_from_numpy(arr, CPU)


def sphere(seed=0):
    """tests/test_mesh.py's sphere with seeded colours."""
    jl = make_sphere_layer([0.05, -0.02, 0.03], 0.5)
    rng = np.random.default_rng(seed)
    col = rng.random(jl.color.shape).astype(np.float32)
    return _pair(dataclasses.replace(jl, color=jnp.asarray(col)))


def dense():
    """Checkerboard sdf over the sphere's live blocks: ~every cell crosses
    zero, overflowing the stock per-chunk capacity."""
    jl = make_sphere_layer([0.05, -0.02, 0.03], 0.5)
    n = int(jl.num_blocks)
    rng = np.random.default_rng(0)
    sdf = np.asarray(jl.sdf).copy()
    sdf[:n] = rng.choice([-0.4, 0.4], size=sdf[:n].shape) * JSPEC.voxel_size
    wgt = np.asarray(jl.weight).copy()
    wgt[:n] = 1.0
    return _pair(dataclasses.replace(jl, sdf=jnp.asarray(sdf),
                                     weight=jnp.asarray(wgt)))


def _close(p, j, atol=1e-5):
    j = np.asarray(j)
    p = p.numpy() if isinstance(p, torch.Tensor) else p
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, atol=atol, rtol=0)


def test_tet_table_matches_jax():
    np.testing.assert_array_equal(pmesh._TRI_EDGES_TABLE,
                                  jmesh._TRI_EDGES_TABLE)
    np.testing.assert_array_equal(pmesh._N_TRIS_TABLE, jmesh._N_TRIS_TABLE)


@pytest.mark.parametrize("chunk_id,cap_mult,min_weight",
                         [(0, 1, 1e-4), (3, 2, 0.5)])
def test_mesh_block_chunk_matches_jax(chunk_id, cap_mult, min_weight):
    jl, pl = sphere()
    slots = np.arange(16, dtype=np.int32) + 16 * chunk_id
    vj, cj, nj, tj = jmesh.mesh_block_chunk(JSPEC, jl, jnp.asarray(slots),
                                            min_weight, cap_mult)
    vp, cp, npp, tp = pmesh.mesh_block_chunk(SPEC, pl,
                                             torch.from_numpy(slots),
                                             min_weight, cap_mult)
    assert int(npp) == int(nj) and int(tp) == int(tj)
    _close(vp, vj)
    _close(cp, cj)


@pytest.mark.parametrize("layer", ["sphere", "dense"])
def test_extract_mesh_device_counts_and_buffers_match_jax(layer):
    """The whole-layer scan: counts and buffers. The dense layer at the
    maximum per-chunk capacity (cap_mult 16), which its self-heal needs."""
    jl, pl = sphere() if layer == "sphere" else dense()
    cap_mult = 1 if layer == "sphere" else 16
    vj, cj, nj, tj = jmesh.extract_mesh_device(JSPEC, jl, 1e-4, 16,
                                               2_000_000, cap_mult=cap_mult)
    vp, cp, npp, tp = pmesh.extract_mesh_device(SPEC, pl, 1e-4, 16,
                                                2_000_000, cap_mult=cap_mult)
    assert int(npp) == int(nj) > 1000 and int(tp) == int(tj)
    _close(vp, vj)
    _close(cp, cj)


def test_extract_mesh_f32_matches_jax():
    """Same triangles in the same order."""
    jl, pl = sphere()
    vj, cj = jmesh.extract_mesh(JSPEC, jl, chunk=16, quantize=False)
    vp, cp = pmesh.extract_mesh(SPEC, pl, chunk=16, quantize=False)
    assert vp.dtype == cp.dtype == np.float32
    assert vp.shape[0] == vj.shape[0] > 1000
    _close(vp, vj)
    _close(cp, cj)


def test_extract_mesh_self_heals_to_the_complete_mesh():
    """A dense layer overflows the per-chunk capacity and, with
    max_tris=1024, the buffer: extract_mesh grows both and returns the
    whole mesh of the maximum-capacity scan (held to the JAX package by
    the test above)."""
    _, pl = dense()
    v, c = pmesh.extract_mesh(SPEC, pl, chunk=16, quantize=False,
                              max_tris=1024)
    vd, cd, n, total = pmesh.extract_mesh_device(SPEC, pl, 1e-4, 16,
                                                 2_000_000, cap_mult=16)
    assert v.shape[0] == int(n) == int(total) > 1024
    assert np.array_equal(v, vd[:, :int(n)].numpy().T.reshape(-1, 3, 3))
    assert np.array_equal(c, cd[:, :int(n)].numpy().T.reshape(-1, 3, 3))


def test_extract_mesh_quantized_matches_jax():
    jl, pl = sphere()
    vj, cj = jmesh.extract_mesh(JSPEC, jl, min_weight=0.1)
    vp, cp = pmesh.extract_mesh(SPEC, pl, min_weight=0.1)
    n = int(jl.num_blocks)
    bc = np.asarray(jl.block_coords)[:n]
    lsb = float(((bc.max(0) + 1 - bc.min(0)) * JSPEC.block_size).max()
                ) / 65535.0
    assert vp.shape == vj.shape and vp.shape[0] > 100
    assert np.abs(vp - vj).max() <= lsb * 1.001
    assert np.abs(cp - cj).max() <= 1.0 / 255.0 + 1e-6
    # and the port's own quantized path against its f32 path
    vf, _ = pmesh.extract_mesh(SPEC, pl, min_weight=0.1, quantize=False)
    assert np.abs(vp - vf).max() <= lsb * 1.001


def test_extract_mesh_of_empty_layer():
    pl = interop.layer_from_numpy(
        {f.name: np.asarray(getattr(jvx.create_tsdf_layer(JSPEC), f.name))
         for f in dataclasses.fields(jvx.TsdfLayer)}, CPU)
    v, c = pmesh.extract_mesh(SPEC, pl)
    assert v.shape == c.shape == (0, 3, 3)


@pytest.mark.parametrize("chunk", [1, 16])
def test_dirty_block_chunks_exact(chunk):
    jl, pl = sphere()
    rng = np.random.default_rng(chunk)
    for share in (0.0, 0.05, 0.5):
        upd = rng.random(JSPEC.max_blocks) < share
        j = jmesh.dirty_block_chunks(JSPEC, jl, jnp.asarray(upd), chunk)
        p = pmesh.dirty_block_chunks(SPEC, pl, torch.from_numpy(upd), chunk)
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_extract_mesh_chunks_device_matches_jax():
    """Chunk ids in any order, negative (padding) ids and a small buffer
    whose running offset clamps at max_tris: every output equal (floats
    1e-5)."""
    jl, pl = sphere()
    ids = np.array([3, 0, -1, 2, 1, -1, 5], np.int32)
    for max_tris in (600,):
        outj = jmesh.extract_mesh_chunks_device(JSPEC, jl, 16, 1e-4,
                                                max_tris, jnp.asarray(ids))
        outp = pmesh.extract_mesh_chunks_device(SPEC, pl, 16, 1e-4,
                                                max_tris,
                                                torch.from_numpy(ids))
        for a, b in zip(outj[2:], outp[2:]):            # offs, cnts, totals
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        _close(outp[0], outj[0])
        _close(outp[1], outj[1])


def _ranges(extract, n_slots):
    """extract(slot_base, n_slots) over consecutive ranges covering the
    pool → the ranges' triangles, concatenated in order, as (T,3,3)."""
    parts = []
    for base in range(0, SPEC.max_blocks, n_slots):
        v, _, k, total = extract(base, min(n_slots, SPEC.max_blocks - base))
        assert int(k) == int(total)
        parts.append(np.asarray(v)[:, :int(k)].T.reshape(-1, 3, 3))
    return np.concatenate(parts)


def _centroids(v):
    return sorted(map(tuple, np.round(v.mean(1) * 1e4).astype(np.int64)))


@pytest.mark.parametrize("n_slots", [32, 24])
def test_extract_mesh_device_slot_ranges_make_the_layer(n_slots):
    """The slot ranges' meshes, concatenated, are the whole layer's mesh:
    the same array when each range is a multiple of the 16-slot chunk, the
    same triangles otherwise (chunks then group slots differently)."""
    _, pl = sphere()
    vw, _, nw, _ = pmesh.extract_mesh_device(SPEC, pl, 1e-4, 16, 200_000)
    whole = vw[:, :int(nw)].numpy().T.reshape(-1, 3, 3)
    got = _ranges(lambda b, n: pmesh.extract_mesh_device(
        SPEC, pl, 1e-4, 16, 200_000, slot_base=b, n_slots=n), n_slots)
    assert got.shape == whole.shape and whole.shape[0] > 1000
    if n_slots % 16 == 0:
        np.testing.assert_array_equal(got, whole)
    else:
        assert _centroids(got) == _centroids(whole)


def test_jax_slot_ranges_overlap_past_a_partial_chunk():
    """Reference fault (ROADMAP queue 3): the JAX package's
    extract_mesh_device meshes whole chunks from slot_base, so a range
    that is not a multiple of the chunk also meshes the next range's first
    slots, and extract_mesh_sharded then returns those triangles twice
    (on a mesh whose device count leaves ⌈max_blocks / D⌉ off the chunk).
    The port stops each range at its end (the test above)."""
    jl, _ = sphere()
    n = int(jmesh.extract_mesh_device(JSPEC, jl, 1e-4, 16, 200_000)[2])
    got = _ranges(lambda b, k: jmesh.extract_mesh_device(
        JSPEC, jl, 1e-4, 16, 200_000, slot_base=b, n_slots=24), 24)
    assert got.shape[0] > n


def test_sharded_extraction_heals_its_capacity():
    """extract_mesh_sharded from a 1,024-triangle buffer on the dense
    layer (its chunks overflow the stock capacity too) returns the whole
    mesh, as extract_mesh does. Reference fault (ROADMAP queue 3): the JAX
    package's keeps its first buffer and drops the rest with a warning —
    at its 250,000-triangle default, most of a bench-scale final mesh."""
    from jax.sharding import Mesh

    from coxgraph_tpu.parallel import merge_sharded as jms
    from coxgraph_tpu_torch.parallel import fleet as fl
    from coxgraph_tpu_torch.parallel import merge_sharded as msh
    from coxgraph_tpu_torch.parallel import multihost

    jl, pl = dense()
    want, want_c = pmesh.extract_mesh(SPEC, pl, chunk=16, quantize=False)
    with multihost.single_process(CPU):
        v, c = msh.extract_mesh_sharded(SPEC, fl.make_robot_mesh(device=CPU),
                                        pl, max_tris_per_device=1024)
    assert v.shape[0] == want.shape[0] > 1024
    np.testing.assert_array_equal(v, want)
    np.testing.assert_array_equal(c, want_c)
    with pytest.warns(RuntimeWarning, match="dropped"):
        vj, _ = jms.extract_mesh_sharded(
            JSPEC, Mesh(np.array(jax.devices()[:1]), ("d",)), jl,
            max_tris_per_device=1024)
    assert vj.shape[0] < want.shape[0]
