"""The allocation pass's wrapper (``ops.cuda_alloc``) on the CPU.

Its two CUDA kernels (``csrc/tsdf_alloc.cu``) run only on a card, where
tests/test_torch_cuda.py holds them to the plain version bit for bit.
Here: CPU tensors take the plain version and launch nothing; the wrapper
refuses operands of the wrong dtype, device or shape; ``runtime.snapshot()``
reports the kernels' launch count; the scratch layout holds every grid the port
uses; and the plain version keeps its contract (the K smallest unique
cells, new blocks on consecutive slots up to max_blocks, only submap k
written) in the cases the card tests run: K cap, full pool, submap k of S,
a grid whose g³ is no multiple of 64. The three frames are rendered once
for the module."""

import dataclasses

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.ops import cuda_alloc
from coxgraph_tpu_torch.ops import tsdf

CPU = torch.device("cpu")
INTR = syn.PinholeIntrinsics().scaled(0.125)     # 80x60
CFG = tsdf.TsdfIntegratorConfig(max_touched_blocks=64)
TABLES = ("block_index", "block_coords", "num_blocks")


def _spec(grid_dim=16, max_blocks=256):
    return vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8,
                            grid_dim=grid_dim, max_blocks=max_blocks,
                            truncation=0.3)


@pytest.fixture(scope="module")
def frames():
    """Three (depth, pose) frames of an orbit, shared by every test here
    (no test writes to them)."""
    scene = syn.default_scene(CPU)
    traj = syn.orbit_trajectory(3, scene.room_center, radius=2.5,
                                sweep=0.3 * np.pi)
    return [(syn.render_depth(scene, INTR, traj[i])[0], traj[i])
            for i in range(3)]


def _tables(spec, S=1):
    """A stacked collection of S submaps with only the block tables the
    pass reads and writes (empty pools)."""
    g, mb = spec.grid_dim, spec.max_blocks
    empty = torch.empty((S, 0))
    return vx.TsdfLayer(
        sdf=empty, weight=empty, color=empty,
        block_index=torch.full((S, g, g, g), -1, dtype=torch.int32),
        block_coords=torch.zeros((S, mb, 3), dtype=torch.int32),
        num_blocks=torch.zeros((S,), dtype=torch.int32))


def _copy(layers):
    return vx.TsdfLayer(**{f.name: getattr(layers, f.name).clone()
                           for f in dataclasses.fields(layers)})


def _k(k=0):
    return torch.full((), k, dtype=torch.int32)


# --- the wrapper on the CPU --------------------------------------------


def test_cpu_pass_is_the_plain_composition(frames):
    """CPU tensors: alloc_pass is alloc_candidates_reference then
    voxel.allocate_and_slots written back into submap k, the live slots
    ORed into ``touched``; no kernel launch is counted."""
    spec = _spec()
    mb, K = spec.max_blocks, CFG.max_touched_blocks
    got, want = _tables(spec), _tables(spec)
    touched = torch.zeros(mb + 1, dtype=torch.bool)
    want_touched = torch.zeros(mb, dtype=torch.bool)
    before = runtime.launches("alloc")
    for depth, T in frames:
        slots, mask = cuda_alloc.alloc_pass(spec, CFG, INTR, got, _k(),
                                            depth, T, touched)
        cells, valid = cuda_alloc.alloc_candidates_reference(
            spec, CFG, INTR, depth, T)
        fi, bc, nb, s, m = vx.allocate_and_slots(
            spec, want.block_index[0].reshape(-1), want.block_coords[0],
            want.num_blocks[0], cells, valid, K)
        want.block_index[0] = fi.view_as(want.block_index[0])
        want.block_coords[0], want.num_blocks[0] = bc, nb
        want_touched[s[m].long()] = True
        assert torch.equal(slots, torch.clamp(s, max=mb - 1))
        assert torch.equal(mask, m) and int(mask.sum()) > 0
        for name in TABLES:
            assert torch.equal(getattr(got, name), getattr(want, name))
        assert torch.equal(touched[:mb], want_touched)
    assert runtime.launches("alloc") == before


META = torch.device("meta")
# operand → (name, a bad value of it, the error): a wrong dtype, device or
# shape of each kind of operand
BAD = {
    "depth_dtype": lambda lay, d, T: ("depth", d.double(), TypeError),
    "depth_shape": lambda lay, d, T: ("depth", d[:-1], ValueError),
    "depth_device": lambda lay, d, T: ("depth", d.to(META), ValueError),
    "depth_strided": lambda lay, d, T: ("depth", d.t().contiguous().t(),
                                        ValueError),
    "pose_shape": lambda lay, d, T: ("T_sm_cam", T[:4], ValueError),
    "pose_dtype": lambda lay, d, T: ("T_sm_cam", T.double(), TypeError),
    "k_dtype": lambda lay, d, T: ("k", _k().long(), TypeError),
    "k_shape": lambda lay, d, T: ("k", _k().reshape(1), ValueError),
    "touched_shape": lambda lay, d, T: (
        "touched", torch.zeros(lay.block_coords.shape[1],
                               dtype=torch.bool), ValueError),
    "num_blocks_shape": lambda lay, d, T: (
        "layers", dataclasses.replace(lay, num_blocks=lay.num_blocks[:0]),
        ValueError),
    "block_index_dtype": lambda lay, d, T: (
        "layers", dataclasses.replace(
            lay, block_index=lay.block_index.long()), TypeError),
    "layers_device": lambda lay, d, T: (
        "layers", vx.TsdfLayer(**{f.name: getattr(lay, f.name).to(META)
                                  for f in dataclasses.fields(lay)}),
        ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_bad_operands(case, frames):
    """A wrong dtype, device or shape raises before any work: the tables
    stay as they were and no launch is counted."""
    spec = _spec()
    lay = _tables(spec)
    depth, T = frames[0]
    name, val, exc = BAD[case](lay, depth, T)
    args = dict(layers=lay, k=_k(), depth=depth, T_sm_cam=T, touched=None)
    args[name] = val
    before = runtime.launches("alloc")
    with pytest.raises(exc):
        cuda_alloc.alloc_pass(spec, CFG, INTR, **args)
    assert runtime.launches("alloc") == before
    assert int(lay.num_blocks[0]) == 0 and int(lay.block_index.max()) == -1


def test_snapshot_reports_alloc_launches(monkeypatch):
    """The wrapper's entry point counts under "alloc" in runtime, and
    launches added there show in snapshot() as "alloc.launches"."""
    monkeypatch.setattr(runtime, "_launch_counts",
                        dict(runtime._launch_counts))
    assert cuda_alloc._ALLOC.name == "alloc"
    before = runtime.snapshot()["counters"]["alloc.launches"]
    runtime.add_launches("alloc", 2)
    assert runtime.snapshot()["counters"]["alloc.launches"] == before + 2
    assert runtime.launches("alloc") == before + 2


@pytest.mark.parametrize("grid_dim", [8, 10, 16, 32, 64])
def test_marks_layout_holds_every_grid(grid_dim):
    """One byte per cell in whole 64-cell groups, 16-byte aligned groups,
    and a summary byte for every group split evenly over 1024 threads."""
    cell_bytes, summary_bytes = cuda_alloc.marks_layout(grid_dim)
    n_groups = cell_bytes // 64
    assert cell_bytes % 64 == 0 and grid_dim ** 3 <= cell_bytes
    assert cell_bytes < grid_dim ** 3 + 64
    assert summary_bytes % 1024 == 0 and n_groups <= summary_bytes
    assert summary_bytes < n_groups + 1024
    marks = cuda_alloc.new_marks(_spec(grid_dim), CPU)
    assert marks.dtype == torch.uint8 and int(marks.count_nonzero()) == 0
    assert marks.numel() == cell_bytes + summary_bytes


# --- the plain version's contract ---------------------------------------


def _contract(spec, K, cells, valid, bi, nb):
    """What the pass must give, from the candidates alone: the K smallest
    unique valid cells in ascending order, each on its slot in ``bi``
    (g³,) or, if new, on ``nb`` + its rank among the new ones while that
    is below max_blocks → (slots clamped to max_blocks - 1, mask, the
    lanes' cells, number of blocks after)."""
    mb = spec.max_blocks
    lanes = np.unique(cells[valid])[:K]
    slots = np.full(K, mb - 1, np.int64)
    mask = np.zeros(K, bool)
    new = 0
    for lane, cell in enumerate(lanes):
        slot = bi[cell]
        if slot < 0:
            slot, new = nb + new, new + 1
        if slot < mb:
            slots[lane], mask[lane] = slot, True
    return slots, mask, lanes, min(nb + new, mb)


CONTRACT = {
    "g16": dict(),
    "g64": dict(grid_dim=64, max_blocks=2048),
    "g10": dict(grid_dim=10),           # g³ = 1000: no multiple of 64
    "k_cap": dict(max_touched=12),
    "near_full": dict(fill=3),
    "k2_of_3": dict(S=3, k=2),
}


@pytest.mark.parametrize("case", list(CONTRACT))
def test_cpu_pass_follows_its_contract(case, frames):
    """Three frames chained through the CPU pass (the plain version the
    kernels are held to on the card), with a scratch it must leave alone:
    slots, mask, submap k's tables and the touched bitmap follow from the
    frame's candidates alone (K smallest unique cells, new blocks on
    consecutive slots in cell order up to max_blocks), and the other
    submaps' tables stay as they were."""
    c = CONTRACT[case]
    spec = _spec(c.get("grid_dim", 16), c.get("max_blocks", 256))
    cfg = dataclasses.replace(
        CFG, max_touched_blocks=c.get("max_touched", 64))
    S, kk = c.get("S", 1), c.get("k", 0)
    mb, gd, h = spec.max_blocks, spec.grid_dim, spec.half_grid
    K = min(cfg.max_touched_blocks, mb)
    layers = _tables(spec, S)
    gen = torch.Generator().manual_seed(len(case))
    for s in range(S):                  # other submaps hold random tables
        if s != kk:
            layers.block_index[s] = torch.randint(
                -1, mb, layers.block_index[s].shape, dtype=torch.int32,
                generator=gen)
            layers.num_blocks[s] = 17
    others = _copy(layers)
    touched = torch.zeros(mb + 1, dtype=torch.bool)
    marks = cuda_alloc.new_marks(spec, CPU)
    want_touched = np.zeros(mb, bool)
    n_unique = []
    for f, (depth, T) in enumerate(frames):
        if f == 1 and "fill" in c:      # the pool within a few slots
            layers.num_blocks[kk] = mb - c["fill"]
        bi = layers.block_index[kk].reshape(-1).numpy().copy()
        bc = layers.block_coords[kk].numpy().copy()
        nb = int(layers.num_blocks[kk])
        cells, valid = cuda_alloc.alloc_candidates_reference(
            spec, cfg, INTR, depth, T)
        n_unique.append(int(torch.unique(cells[valid]).numel()))
        slots, mask, lanes, nb_after = _contract(
            spec, K, cells.numpy(), valid.numpy(), bi, nb)
        got_s, got_m = cuda_alloc.alloc_pass(spec, cfg, INTR, layers,
                                             _k(kk), depth, T, touched,
                                             marks)
        np.testing.assert_array_equal(got_s.numpy(), slots)
        np.testing.assert_array_equal(got_m.numpy(), mask)
        assert int(layers.num_blocks[kk]) == nb_after
        live = slots[mask]
        assert len(np.unique(live)) == len(live)
        for cell, slot, m in zip(lanes, slots, mask):
            if m:               # the lane's cell holds its slot both ways
                bi[cell] = slot
                bc[slot] = (cell // (gd * gd) - h, cell // gd % gd - h,
                            cell % gd - h)
        np.testing.assert_array_equal(
            layers.block_index[kk].reshape(-1).numpy(), bi)
        np.testing.assert_array_equal(layers.block_coords[kk].numpy(), bc)
        want_touched[live] = True
        np.testing.assert_array_equal(touched[:mb].numpy(), want_touched)
        assert int(marks.count_nonzero()) == 0
    for s in range(S):
        if s != kk:
            for name in TABLES:
                assert torch.equal(getattr(layers, name)[s],
                                   getattr(others, name)[s])
    if case == "k_cap":
        assert min(n_unique) > K
    if case == "near_full":
        assert int(layers.num_blocks[kk]) == mb
