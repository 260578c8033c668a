"""coxgraph_tpu_torch.core.voxel vs coxgraph_tpu.core.voxel: candidate
compaction, allocation and lookup must be EXACT (integer outputs decide
which pool row each block lives in)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.utils import interop

JSPEC = jvx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                          max_blocks=64, truncation=0.3)
SPEC = interop.config_from(JSPEC)
CPU = torch.device("cpu")
G3 = JSPEC.grid_dim ** 3


def _candidates(n, seed, n_distinct=40, valid_share=0.7):
    """Seeded candidate cells: heavy duplicates, invalid lanes, and
    out-of-range ids riding along on invalid lanes."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(G3, size=n_distinct, replace=False)
    gs = pool[rng.integers(0, n_distinct, size=n)].astype(np.int32)
    valid = rng.random(n) < valid_share
    gs[~valid & (rng.random(n) < 0.5)] = G3 + 7
    return gs, valid


def _both(fn_j, fn_p, *args):
    return (fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args)),
            fn_p(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args)))


def _eq(j, p):
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("n,k,seed", [(500, 32, 0), (500, 64, 1),
                                      (10, 32, 2), (1, 8, 3), (2000, 16, 4)],
                         ids=["dups", "wide", "n_lt_k", "single", "overflow"])
def test_candidate_cells_exact(n, k, seed):
    gs, valid = _candidates(n, seed)
    j, p = _both(lambda g, v: jvx.candidate_cells(JSPEC, g, v, k),
                 lambda g, v: vx.candidate_cells(SPEC, g, v, k), gs, valid)
    assert p.dtype == torch.int32 and p.shape == (k,)
    _eq(j, p)


def test_candidate_cells_all_invalid():
    gs, _ = _candidates(50, 5)
    valid = np.zeros(50, bool)
    j, p = _both(lambda g, v: jvx.candidate_cells(JSPEC, g, v, 16),
                 lambda g, v: vx.candidate_cells(SPEC, g, v, 16), gs, valid)
    _eq(j, p)
    assert (p == G3).all()


def _run_allocations(jspec, n_frames, k, seed, prefill=0):
    """Chain allocate_and_slots over seeded frames on both sides, comparing
    every output after every frame."""
    spec = interop.config_from(jspec)
    jl = jvx.create_tsdf_layer(jspec)
    pl = vx.create_tsdf_layer(spec, CPU)
    fi_j, bc_j, nb_j = (jl.block_index.reshape(-1), jl.block_coords,
                        jl.num_blocks)
    fi_p, bc_p, nb_p = (pl.block_index.reshape(-1), pl.block_coords,
                        pl.num_blocks)
    if prefill:
        nb_j = jnp.asarray(prefill, jnp.int32)
        nb_p = torch.tensor(prefill, dtype=torch.int32)
    for f in range(n_frames):
        gs, valid = _candidates(300, seed + f, n_distinct=60)
        fi_j, bc_j, nb_j, s_j, m_j = jvx.allocate_and_slots(
            jspec, fi_j, bc_j, nb_j, jnp.asarray(gs), jnp.asarray(valid), k)
        fi_p, bc_p, nb_p, s_p, m_p = vx.allocate_and_slots(
            spec, fi_p, bc_p, nb_p, torch.from_numpy(gs),
            torch.from_numpy(valid), k)
        for j, p in ((fi_j, fi_p), (bc_j, bc_p), (nb_j, nb_p), (s_j, s_p),
                     (m_j, m_p)):
            _eq(j, p)
        live = s_p[m_p].numpy()
        assert len(np.unique(live)) == len(live)      # unique live slots
    return fi_p, bc_p, nb_p


def test_allocate_and_slots_exact_across_frames():
    _, _, nb = _run_allocations(JSPEC, n_frames=4, k=48, seed=10)
    assert 0 < int(nb) <= JSPEC.max_blocks


def test_allocate_and_slots_exact_at_saturation():
    # 64-block pool pre-filled to 50: new cells run out of slots mid-frame
    _, _, nb = _run_allocations(JSPEC, n_frames=3, k=48, seed=20,
                                prefill=50)
    assert int(nb) == JSPEC.max_blocks


def test_allocate_cells_exact_on_padded_cells():
    # N < K padding lanes (g3) and cells already allocated
    gs, valid = _candidates(12, 30)
    t_cells = jvx.candidate_cells(JSPEC, jnp.asarray(gs), jnp.asarray(valid),
                                  32)
    jl = jvx.create_tsdf_layer(JSPEC)
    pl = vx.create_tsdf_layer(SPEC, CPU)
    for _ in range(2):           # second pass: every cell already exists
        out_j = jvx.allocate_cells(JSPEC, jl.block_index.reshape(-1),
                                   jl.block_coords, jl.num_blocks, t_cells)
        out_p = vx.allocate_cells(SPEC, pl.block_index.reshape(-1),
                                  pl.block_coords, pl.num_blocks,
                                  torch.from_numpy(np.array(t_cells)))
        for j, p in zip(out_j, out_p):
            _eq(j, p)
        jl = dataclasses.replace(jl, block_index=out_j[0].reshape(
            jl.block_index.shape), block_coords=out_j[1],
            num_blocks=out_j[2])
        pl = dataclasses.replace(pl, block_index=out_p[0].reshape(
            pl.block_index.shape), block_coords=out_p[1],
            num_blocks=out_p[2])


def test_lookup_block_exact():
    fi, bc, nb = _run_allocations(JSPEC, n_frames=2, k=48, seed=40)
    rng = np.random.default_rng(41)
    # in-grid coords, coords of allocated blocks, and out-of-grid coords
    coords = np.concatenate([
        rng.integers(-8, 8, size=(100, 3)),
        bc.numpy()[:int(nb)],
        rng.integers(-30, 30, size=(100, 3)),
    ]).astype(np.int32)
    jl = dataclasses.replace(jvx.create_tsdf_layer(JSPEC),
                             block_index=jnp.asarray(fi.numpy()).reshape(
                                 (16, 16, 16)))
    pl = dataclasses.replace(vx.create_tsdf_layer(SPEC, CPU),
                             block_index=fi.reshape(16, 16, 16))
    j = jvx.lookup_block(JSPEC, jl, jnp.asarray(coords))
    p = vx.lookup_block(SPEC, pl, torch.from_numpy(coords))
    _eq(j, p)
    assert (p.numpy()[100:100 + int(nb)] >= 0).all()


@pytest.mark.parametrize("fn", ["block_grid_slot", "block_in_grid",
                                "block_origin", "voxel_centers_of_block"])
def test_block_helpers_match_jax(fn):
    coords = np.random.default_rng(50).integers(
        -12, 12, size=(40, 3)).astype(np.int32)
    j = getattr(jvx, fn)(JSPEC, jnp.asarray(coords))
    p = getattr(vx, fn)(SPEC, torch.from_numpy(coords))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_create_tsdf_layer_matches_jax():
    j = jvx.create_tsdf_layer(JSPEC)
    p = vx.create_tsdf_layer(SPEC, CPU)
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(p, f.name).numpy(),
                                      np.asarray(getattr(j, f.name)))


@pytest.mark.parametrize("fn", ["point_to_voxel", "voxel_to_block"])
def test_voxel_index_helpers_match_jax(fn):
    rng = np.random.default_rng(60)
    if fn == "point_to_voxel":
        x = rng.uniform(-3.0, 3.0, size=(500, 3)).astype(np.float32)
    else:       # negative global voxel indices need floor division
        x = rng.integers(-70, 70, size=(500, 3)).astype(np.int32)
    j = getattr(jvx, fn)(JSPEC, jnp.asarray(x))
    p = getattr(vx, fn)(SPEC, torch.from_numpy(x))
    for a, b in zip(j if isinstance(j, tuple) else (j,),
                    p if isinstance(p, tuple) else (p,)):
        assert b.dtype == torch.int32
        _eq(a, b)


@pytest.mark.parametrize("prefill,use_mask", [(0, False), (0, True),
                                              (50, False)],
                         ids=["plain", "masked", "saturating"])
def test_allocate_blocks_exact(prefill, use_mask):
    """Duplicate, out-of-grid and masked coords; a pool that runs out."""
    rng = np.random.default_rng(70 + prefill)
    jl = jvx.create_tsdf_layer(JSPEC)
    pl = vx.create_tsdf_layer(SPEC, CPU)
    if prefill:
        jl = dataclasses.replace(jl, num_blocks=jnp.asarray(prefill,
                                                            jnp.int32))
        pl.num_blocks.fill_(prefill)
    for step in range(3):
        coords = rng.integers(-10, 10, size=(200, 3)).astype(np.int32)
        mask = rng.random(200) < 0.6 if use_mask else None
        jl = jvx.allocate_blocks(JSPEC, jl, jnp.asarray(coords),
                                 None if mask is None else jnp.asarray(mask))
        pl = vx.allocate_blocks(SPEC, pl, torch.from_numpy(coords),
                                None if mask is None
                                else torch.from_numpy(mask))
        for name in ("block_index", "block_coords", "num_blocks"):
            _eq(getattr(jl, name), getattr(pl, name))
    assert int(pl.num_blocks) > prefill


def _random_layer(seed):
    """A layer with allocated blocks, random sdf and weights (a tenth
    of the voxels unobserved) on both sides."""
    rng = np.random.default_rng(seed)
    coords = rng.integers(-3, 3, size=(60, 3)).astype(np.int32)
    jl = jvx.allocate_blocks(JSPEC, jvx.create_tsdf_layer(JSPEC),
                             jnp.asarray(coords))
    arr = {f.name: np.array(getattr(jl, f.name))
           for f in dataclasses.fields(jl)}
    arr["sdf"] = rng.uniform(-0.3, 0.3, arr["sdf"].shape).astype(np.float32)
    arr["weight"] = (rng.uniform(0.5, 2.0, arr["weight"].shape)
                     * (rng.random(arr["weight"].shape) < 0.9)
                     ).astype(np.float32)
    return (jvx.TsdfLayer(**{k: jnp.asarray(v) for k, v in arr.items()}),
            interop.layer_from_numpy(arr, CPU))


def test_voxel_lookup_exact():
    jl, pl = _random_layer(80)
    v = np.random.default_rng(81).integers(-30, 30, size=(2000, 3)).astype(
        np.int32)
    for a, b in zip(jvx.voxel_lookup(JSPEC, jl, jnp.asarray(v)),
                    vx.voxel_lookup(SPEC, pl, torch.from_numpy(v))):
        _eq(a, b)


def test_sample_tsdf_trilinear_matches_jax():
    """Random points (never on a voxel centre): valid exact, sdf and
    weight within 1e-5 (XLA fuses the weights' multiply-adds; observed
    max |Δ| ~3e-7)."""
    jl, pl = _random_layer(90)
    p = np.random.default_rng(91).uniform(-2.0, 2.0, size=(3000, 3)).astype(
        np.float32)
    sj, wj, okj = jvx.sample_tsdf_trilinear(JSPEC, jl, jnp.asarray(p))
    sp, wp, okp = vx.sample_tsdf_trilinear(SPEC, pl, torch.from_numpy(p))
    _eq(okj, okp)
    assert int(okp.sum()) > 100
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("delta", [None, 0.03])
def test_sample_tsdf_gradient_matches_jax(delta):
    """Central differences of six trilinear samples at points inside
    allocated blocks: valid exact (218 and 2,681 valid of 20,000),
    gradient within 1e-4 (a sample's ~3e-7 difference over 2·delta;
    observed max |Δ| 2.2e-5)."""
    jl, pl = _random_layer(92)
    rng = np.random.default_rng(93)
    n = int(jl.num_blocks)
    blocks = np.asarray(jl.block_coords)[rng.integers(0, n, 20000)]
    p = ((blocks + rng.uniform(0, 1, (20000, 3))) * JSPEC.block_size
         ).astype(np.float32)
    gj, okj = jvx.sample_tsdf_gradient(JSPEC, jl, jnp.asarray(p), delta)
    gp, okp = vx.sample_tsdf_gradient(SPEC, pl, torch.from_numpy(p), delta)
    _eq(okj, okp)
    assert int(okp.sum()) > 150
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), atol=1e-4,
                               rtol=0)
