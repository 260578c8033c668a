"""GPU tests of the port's CUDA kernels (marker ``cuda``; each skips
without a card). The machine with the card has no JAX, so this file
imports none, and neither may its run load tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances: the kernel vs its torch twin on the card — bit-identical
(same op order, f32, no fused multiply-add on either side); the GPU path
vs the CPU path (which runs the twin) — integers exact, float pools with
the share of |Δ| > 1e-4 below 1e-3, room for a last-bit difference
between the CPU's and the card's libraries to move a voxel's pixel at a
rounding boundary. The Hamming kernel vs its torch version: every output
exact (integers). The loop detector on the card vs on the CPU: slot
tables, scores and message pairs exact."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.frontends import loop_detector as ld
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import cuda_alloc, cuda_esdf, cuda_hamming
from coxgraph_tpu_torch.ops import cuda_tsdf
from coxgraph_tpu_torch.ops import esdf as esdf_ops
from coxgraph_tpu_torch.ops import features as ft
from coxgraph_tpu_torch.ops import tsdf

INTR = syn.PinholeIntrinsics().scaled(0.125)     # 80x60
CFG = tsdf.TsdfIntegratorConfig(max_touched_blocks=64)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _frames(device, n=2):
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(n, scene.room_center, radius=2.5,
                                sweep=0.3 * np.pi)
    fr = [syn.render_depth(scene, INTR, traj[i]) for i in range(n)]
    return (torch.stack([f[0] for f in fr]), torch.stack([f[1] for f in fr]),
            traj)


def _stacked(spec, device):
    layer = vx.create_tsdf_layer(spec, device)
    return vx.TsdfLayer(**{f.name: getattr(layer, f.name)[None]
                           for f in dataclasses.fields(layer)})


def _spec(vps):
    """10 cm voxels (5 cm at 16³): 4³, 8³ and 16³ rows take the kernel's
    2-voxels-per-thread path, 5³ rows (500 bytes) its per-voxel path."""
    return vx.VoxelGridSpec(voxel_size=0.05 if vps == 16 else 0.1,
                            voxels_per_side=vps, grid_dim=16,
                            max_blocks=256, truncation=0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("vps", [4, 5, 8, 16])
def test_kernel_matches_twin(gpu, vps):
    spec = _spec(vps)
    depths, colors, traj = _frames(gpu)
    planar = colors.permute(0, 3, 1, 2).contiguous()
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    lk, lt = _stacked(spec, gpu), _stacked(spec, gpu)
    marks = cuda_alloc.new_marks(spec, gpu)
    for f in range(2):
        sk, mk = cuda_alloc.alloc_pass(spec, CFG, INTR, lk, k, depths[f],
                                       traj[f], None, marks)
        st, mt = cuda_alloc.alloc_pass_reference(spec, CFG, INTR, lt, k,
                                                 depths[f], traj[f])
        assert torch.equal(sk, st) and torch.equal(mk, mt)
        args = (k, sk, mk, depths[f], planar[f],
                geo.inverse(traj[f]).contiguous())
        before = runtime.launches("k1")
        cuda_tsdf.update_blocks(spec, CFG, INTR, lk, *args)
        assert runtime.launches("k1") == before + 1
        cuda_tsdf.update_blocks_reference(spec, CFG, INTR, lt, *args)
        torch.cuda.synchronize()
        assert int((lt.weight > 0).sum()) > min(1000, 4 * vps ** 3)
        for f_ in dataclasses.fields(lk):
            assert torch.equal(getattr(lk, f_.name),
                               getattr(lt, f_.name)), f_.name


@pytest.mark.cuda
@pytest.mark.parametrize("vps", [5, 16])
def test_kernel_edge_lanes_match_twin(gpu, vps):
    """Hand-made lanes on random pools: K = 37 (a multiple of no chunk),
    holes in the mask (first and last lane too), masked lanes clamped onto
    slot mb - 1 that another lane holds live, a masked lane on a row no
    lane holds, submap k = 2 of S = 3, no colour image, drop-off and
    distance weight off. Kernel ≡ twin on every pool, live rows changed,
    every other row of every submap bit for bit as it was."""
    spec = _spec(vps)
    cfg = dataclasses.replace(CFG, use_dropoff=False,
                              use_distance_weight=False)
    mb, K, kk = spec.max_blocks, 37, 2
    depths, _, traj = _frames(gpu, 1)
    one = vx.create_tsdf_layer(spec, gpu)
    base = vx.TsdfLayer(**{f.name: torch.stack([getattr(one, f.name)] * 3)
                           for f in dataclasses.fields(one)})
    k = torch.full((), kk, dtype=torch.int32, device=gpu)
    cuda_alloc.alloc_pass(spec, cfg, INTR, base, k, depths[0], traj[0],
                          None, cuda_alloc.new_marks(spec, gpu))
    n_alloc = int(base.num_blocks[kk])
    assert n_alloc > 0
    g = torch.Generator(device=gpu).manual_seed(vps)
    base.sdf.uniform_(-0.3, 0.3, generator=g)
    base.weight.uniform_(0.0, 3.0, generator=g)
    base.weight.mul_(torch.rand(base.weight.shape, generator=g,
                                device=gpu) < 0.7)
    base.color.uniform_(0.0, 1.0, generator=g)

    rng = np.random.default_rng(vps)
    holes = [0, 5, 6, 20, K - 1]
    live = [i for i in range(K) if i not in holes]
    free = rng.permutation(mb - 1)
    slots = np.full(K, mb - 1)
    slots[live] = free[:len(live)]
    slots[live[3]] = mb - 1              # live on the masked lanes' row
    slots[20] = free[len(live)]          # masked, on a row no lane holds
    mask = np.zeros(K, bool)
    mask[live] = True
    live_slots = torch.from_numpy(slots[live]).to(gpu).long()
    # every live block is one the frame sees
    base.block_coords[kk, live_slots] = base.block_coords[kk, torch.from_numpy(
        rng.integers(0, n_alloc, len(live))).to(gpu)]
    args = (k, torch.from_numpy(slots.astype(np.int32)).to(gpu),
            torch.from_numpy(mask).to(gpu), depths[0], None,
            geo.inverse(traj[0]).contiguous())
    lk, lt = (vx.TsdfLayer(**{f.name: getattr(base, f.name).clone()
                             for f in dataclasses.fields(base)})
              for _ in range(2))
    before = runtime.launches("k1")
    cuda_tsdf.update_blocks(spec, cfg, INTR, lk, *args)
    assert runtime.launches("k1") == before + 1
    cuda_tsdf.update_blocks_reference(spec, cfg, INTR, lt, *args)
    torch.cuda.synchronize()
    for f_ in dataclasses.fields(lk):
        assert torch.equal(getattr(lk, f_.name),
                           getattr(lt, f_.name)), f_.name
    touched = torch.zeros((3, mb), dtype=torch.bool, device=gpu)
    touched[kk, live_slots] = True
    for name in ("sdf", "weight"):
        assert not torch.equal(getattr(lk, name)[touched],
                               getattr(base, name)[touched]), name
    for name in ("sdf", "weight", "color"):
        assert torch.equal(getattr(lk, name)[~touched],
                           getattr(base, name)[~touched]), name
    assert torch.equal(lk.color, base.color)


@pytest.mark.cuda
def test_wrapper_rejects_misaligned_pools(gpu):
    """Rows of 8-byte multiples go to the kernel's 8-byte path, so a pool
    that starts off an 8-byte boundary is refused; 5³ rows are not."""
    depths, colors, traj = _frames(gpu, 1)
    planar = colors[0].permute(2, 0, 1).contiguous()
    for vps, refused in ((8, True), (5, False)):
        spec = _spec(vps)
        lay = _stacked(spec, gpu)
        off = torch.zeros(lay.sdf.numel() + 1, device=gpu)[1:]
        lay = dataclasses.replace(lay, sdf=off.view(lay.sdf.shape))
        args = (torch.zeros((), dtype=torch.int32, device=gpu),
                torch.zeros(64, dtype=torch.int32, device=gpu),
                torch.zeros(64, dtype=torch.bool, device=gpu), depths[0],
                planar, geo.inverse(traj[0]).contiguous())
        before = runtime.launches("k1")
        if refused:
            with pytest.raises(ValueError):
                cuda_tsdf.update_blocks(spec, CFG, INTR, lay, *args)
        else:
            cuda_tsdf.update_blocks(spec, CFG, INTR, lay, *args)
        assert runtime.launches("k1") == before + (not refused)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(gpu):
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                            max_blocks=256, truncation=0.3)
    depths, colors, traj = _frames(gpu, 1)
    lay = _stacked(spec, gpu)
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    slots = torch.zeros(64, dtype=torch.int32, device=gpu)
    mask = torch.zeros(64, dtype=torch.bool, device=gpu)
    planar = colors[0].permute(2, 0, 1).contiguous()
    T = geo.inverse(traj[0]).contiguous()
    good = dict(k=k, slots=slots, slot_mask=mask, depth=depths[0],
                color=planar, T_cam_sm=T)
    bad = [("slots", slots.long(), TypeError),
           ("depth", depths[0].cpu(), ValueError),
           ("color", colors[0], ValueError),            # interleaved
           ("color", colors[0].permute(2, 0, 1), ValueError),  # strided
           ("k", k.reshape(1), ValueError)]
    before = runtime.launches("k1")
    for name, val, exc in bad:
        with pytest.raises(exc):
            cuda_tsdf.update_blocks(spec, CFG, INTR, lay,
                                    **dict(good, **{name: val}))
    assert runtime.launches("k1") == before


@pytest.mark.cuda
def test_step_batch_on_gpu_matches_cpu(gpu):
    cfg = sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8,
                              grid_dim=32, max_blocks=1024, truncation=0.3),
        integrator=tsdf.TsdfIntegratorConfig(max_touched_blocks=512),
        intrinsics=INTR, max_submaps=8, max_history=64,
        submap_interval=0.3)
    depths, colors, traj = _frames(torch.device("cpu"), 8)
    ts = np.arange(8) * 0.1
    out = {}
    for dev in (torch.device("cpu"), gpu):
        hm = sm.HostMapper(cfg, device=dev)
        before = runtime.launches("k1")
        assert hm.step_batch(depths.to(dev), colors.to(dev),
                             traj.to(dev), ts) == 3
        launched = runtime.launches("k1") - before
        assert launched == (8 if dev.type == "cuda" else 0)
        out[dev.type] = hm.state
    for name in ("block_index", "block_coords", "num_blocks"):
        assert torch.equal(getattr(out["cuda"].collection.layers, name).cpu(),
                           getattr(out["cpu"].collection.layers, name))
    assert torch.equal(out["cuda"].mesh_dirty.cpu(), out["cpu"].mesh_dirty)
    assert torch.equal(out["cuda"].collection.hist_count.cpu(),
                       out["cpu"].collection.hist_count)
    for name in ("sdf", "weight", "color"):
        d = (getattr(out["cuda"].collection.layers, name).cpu()
             - getattr(out["cpu"].collection.layers, name)).abs()
        assert float((d > 1e-4).float().mean()) < 1e-3, name


def _tables(spec, S, device):
    """A stacked collection of S submaps with only the block tables the
    allocation pass reads and writes (empty pools)."""
    g, mb = spec.grid_dim, spec.max_blocks
    empty = torch.empty((S, 0), device=device)
    return vx.TsdfLayer(
        sdf=empty, weight=empty, color=empty,
        block_index=torch.full((S, g, g, g), -1, dtype=torch.int32,
                               device=device),
        block_coords=torch.zeros((S, mb, 3), dtype=torch.int32,
                                 device=device),
        num_blocks=torch.zeros((S,), dtype=torch.int32, device=device))


def _alloc_kernels_vs_plain(spec, cfg, intr, layers, k, frames, fill=None):
    """Each (depth, T_sm_cam) of ``frames`` through the two kernels on
    ``layers`` and through the plain version on a copy, in turn. After
    every frame: slots, slot_mask, every submap's tables and the touched
    bitmaps equal (torch.equal), the kernels' scratch zero again and 2
    launches counted. ``fill`` = (frame, n): before that frame both pools
    are set to within n slots of max_blocks → unique cells per frame."""
    mb = spec.max_blocks
    plain = vx.TsdfLayer(**{f.name: getattr(layers, f.name).clone()
                            for f in dataclasses.fields(layers)})
    dev = layers.block_index.device
    touched = [torch.zeros(mb + 1, dtype=torch.bool, device=dev)
               for _ in range(2)]
    marks = cuda_alloc.new_marks(spec, dev)
    unique = []
    for f, (depth, T) in enumerate(frames):
        if fill is not None and f == fill[0]:
            for lay in (layers, plain):
                lay.num_blocks[k.long()] = mb - fill[1]
        cells, valid = cuda_alloc.alloc_candidates_reference(
            spec, cfg, intr, depth, T)
        unique.append(int(torch.unique(cells[valid]).numel()))
        before = runtime.launches("alloc")
        sk, mk = cuda_alloc.alloc_pass(spec, cfg, intr, layers, k, depth, T,
                                       touched[0], marks)
        assert runtime.launches("alloc") == before + 2
        sp, mp = cuda_alloc.alloc_pass_reference(spec, cfg, intr, plain, k,
                                                 depth, T, touched[1])
        torch.cuda.synchronize()
        assert torch.equal(sk, sp) and torch.equal(mk, mp), f
        for name in ("block_index", "block_coords", "num_blocks"):
            assert torch.equal(getattr(layers, name),
                               getattr(plain, name)), (f, name)
        assert torch.equal(touched[0][:mb], touched[1][:mb]), f
        assert int(marks.count_nonzero()) == 0, f
    return unique


def _orbit(device, intr, n, radius=2.5):
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(n, scene.room_center, radius=radius,
                                sweep=0.3 * np.pi)
    return [(syn.render_depth(scene, intr, traj[i])[0], traj[i])
            for i in range(n)]


def _edge_depth(depth):
    """Holes (0, NaN, inf, beyond max range) and pixels so near that the
    band's first samples lie behind the camera."""
    d = depth.clone()
    d[:8, :16] = 0.0
    d[8:12, :16] = float("nan")
    d[12:16, :16] = float("inf")
    d[16:20, :16] = 11.0
    d[20:28, 16:40] = 0.15
    return d


ALLOC_CASES = {
    # (intrinsics scale, grid_dim, max_blocks, max_touched, S, k)
    "80x60_g16": (0.125, 16, 256, 64, 1, 0),
    "80x60_g64": (0.125, 64, 2048, 512, 1, 0),
    "k_cap": (0.125, 16, 256, 12, 1, 0),
    "near_full": (0.125, 16, 256, 64, 1, 0),
    "edges": (0.125, 8, 256, 64, 1, 0),
    "k2_of_3": (0.125, 16, 256, 64, 3, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ALLOC_CASES))
def test_alloc_kernels_match_plain(gpu, case):
    """The allocation pass's two kernels ≡ its plain version on the card,
    three frames chained, at 80×60: 16³ and 64³ grids; more unique cells
    than max_touched_blocks (the K cap); a pool filled to within 3 slots
    of max_blocks; candidates outside an 8³ grid, behind the camera and
    in holes of the depth; submap k = 2 of S = 3 whose other submaps hold
    random tables, left unchanged."""
    scale, g, mb, K, S, kk = ALLOC_CASES[case]
    intr = syn.PinholeIntrinsics().scaled(scale)
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=g,
                            max_blocks=mb, truncation=0.3)
    cfg = dataclasses.replace(CFG, max_touched_blocks=K)
    frames = _orbit(gpu, intr, 3)
    if case == "edges":
        frames = [(_edge_depth(d), T) for d, T in frames]
        big = dataclasses.replace(spec, grid_dim=64)
        for d, T in frames:     # some valid candidates leave the 8³ grid
            assert int(cuda_alloc.alloc_candidates_reference(
                big, cfg, intr, d, T)[1].sum()) > int(
                cuda_alloc.alloc_candidates_reference(
                    spec, cfg, intr, d, T)[1].sum())
    layers = _tables(spec, S, gpu)
    gen = torch.Generator(device=gpu).manual_seed(S)
    for s_ in range(S):
        if s_ != kk:
            layers.block_index[s_] = torch.randint(
                -1, mb, layers.block_index[s_].shape, dtype=torch.int32,
                generator=gen, device=gpu)
            layers.block_coords[s_] = torch.randint(
                -g // 2, g // 2, (mb, 3), dtype=torch.int32, generator=gen,
                device=gpu)
            layers.num_blocks[s_] = 100 + s_
    others = [getattr(layers, n)[[s_ for s_ in range(S) if s_ != kk]].clone()
              for n in ("block_index", "block_coords", "num_blocks")]
    k = torch.full((), kk, dtype=torch.int32, device=gpu)
    unique = _alloc_kernels_vs_plain(
        spec, cfg, intr, layers, k, frames,
        fill=(1, 3) if case == "near_full" else None)
    assert int(layers.num_blocks[kk]) > 0
    rest = [s_ for s_ in range(S) if s_ != kk]
    for t, n in zip(others, ("block_index", "block_coords", "num_blocks")):
        assert torch.equal(getattr(layers, n)[rest], t), n
    if case == "k_cap":
        assert min(unique) > K
    if case == "near_full":
        assert int(layers.num_blocks[kk]) == mb


@pytest.mark.cuda
def test_alloc_kernels_match_plain_at_client_vga(gpu):
    """One 640×480 frame at client_vga's mapper (5 cm voxels, 16³ blocks,
    a 64³ grid, 8,192 blocks, 2,048 lanes, stride 4, 3 band samples),
    then a second frame on the tables the first left."""
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16,
                            grid_dim=64, max_blocks=8192, truncation=0.15)
    cfg = tsdf.TsdfIntegratorConfig(max_touched_blocks=2048)
    intr = syn.PinholeIntrinsics()
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    layers = _tables(spec, 1, gpu)
    unique = _alloc_kernels_vs_plain(spec, cfg, intr, layers, k,
                                     _orbit(gpu, intr, 2, radius=2.4))
    assert min(unique) > 50 and int(layers.num_blocks[0]) > 150


@pytest.mark.cuda
def test_alloc_kernels_match_plain_over_a_window(gpu):
    """A 30-frame window at 80×60 chained frame after frame on one
    scratch, the touched bitmaps ORed over the window alike."""
    spec = _spec(8)
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    layers = _tables(spec, 1, gpu)
    _alloc_kernels_vs_plain(spec, CFG, INTR, layers, k, _orbit(gpu, INTR, 30))
    assert int(layers.num_blocks[0]) > 64


@pytest.mark.cuda
def test_alloc_kernels_need_the_scratch(gpu):
    """On the card the pass refuses to run without the scratch from
    new_marks: the tables stay as they were and no launch is counted."""
    spec = _spec(8)
    layers = _tables(spec, 1, gpu)
    depth, T = _orbit(gpu, INTR, 1)[0]
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    before = runtime.launches("alloc")
    with pytest.raises(ValueError, match="new_marks"):
        cuda_alloc.alloc_pass(spec, CFG, INTR, layers, k, depth, T)
    assert runtime.launches("alloc") == before
    assert int(layers.num_blocks[0]) == 0
    assert int(layers.block_index.max()) == -1


@pytest.mark.cuda
def test_step_batch_takes_the_alloc_kernels(gpu, monkeypatch):
    """HostMapper.step_batch on the card: 2 allocation launches and one
    K1 launch a frame, and no CUDA tensor reaches the plain pass."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain allocation pass ran on the card")
    monkeypatch.setattr(cuda_alloc, "alloc_pass_reference", refuse)
    cfg = sm.MapperConfig(spec=_spec(8), integrator=CFG, intrinsics=INTR,
                          max_submaps=4, max_history=64, submap_interval=10.0)
    depths, colors, traj = _frames(gpu, 6)
    hm = sm.HostMapper(cfg, device=gpu)
    a0, k0 = runtime.launches("alloc"), runtime.launches("k1")
    hm.step_batch(depths, colors, traj, np.arange(6) * 0.1)
    torch.cuda.synchronize()
    assert runtime.launches("alloc") - a0 == 12
    assert runtime.launches("k1") - k0 == 6
    assert int(hm.state.collection.layers.num_blocks[0]) > 0


def _words(gen, *shape, device):
    return torch.randint(-2 ** 31, 2 ** 31, (*shape, 8), dtype=torch.int32,
                         generator=gen, device=device)


# K2's edge shapes: Ka not a multiple of its row tiles, Kb of 1, 7, 200
EDGES = [(ka, kb) for ka in (100, 200) for kb in (1, 7, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb", [(128, 96), (384, 200), (1, 1), (300, 512),
                                   (4000, 1024)] + EDGES)
def test_hamming_topk_kernel_matches_plain(gpu, ka, kb):
    g = torch.Generator(device=gpu).manual_seed(ka + kb)
    da, db = _words(g, ka, device=gpu), _words(g, kb, device=gpu)
    db[: min(ka, kb) // 2] = da[: min(ka, kb) // 2]    # exact matches
    db[-1] = db[0]                                     # tied columns
    before = runtime.launches("k2")
    got = cuda_hamming.hamming_match_topk(da, db)
    assert runtime.launches("k2") == before + 1
    want = cuda_hamming.hamming_match_topk_reference(da, db)
    for g_, w, name in zip(got, want, ("d1", "i1", "d2")):
        assert g_.dtype == torch.int32 and torch.equal(g_, w), name


def edge_cases(a, av, b, bv):
    """Edit drawn matcher inputs, in place, into K2's masking and tie
    cases: exact matches, a repeated row, column and slot (ties across
    rows, columns and slots), query row 1 and database column 2 invalid,
    the last slot and (nq > 1) the last query wholly invalid. b is shared
    when its leading size is 1. tests/test_torch_hamming_keys.py uses it
    too; chip_smoke.py, which stands alone, keeps a copy."""
    nq, ka = av.shape
    kb = b.shape[2]
    n = min(ka, kb) // 2
    b[:, :, :n] = a[:, None, :n] if b.shape[0] == nq else a[0, :n]
    b[:, :, -1] = b[:, :, 0]
    a[:, -1] = a[:, 0]
    if b.shape[1] > 2:
        b[:, 2] = b[:, 1]
    av[0, 1] = False
    bv[:, 0, 2 % kb] = False
    bv[:, -1] = False
    if nq > 1:
        av[-1] = False


def _match_inputs(g, nq, cap, ka, kb, shared, device):
    """Random words, ~90% valid, edited by edge_cases."""
    a = _words(g, nq, ka, device=device)
    b = _words(g, 1 if shared else nq, cap, kb, device=device)
    av = torch.rand(nq, ka, generator=g, device=device) < 0.9
    bv = torch.rand(b.shape[:-1], generator=g, device=device) < 0.9
    edge_cases(a, av, b, bv)
    return a, av, b, bv


@pytest.mark.cuda
@pytest.mark.parametrize("shared,nq,cap,ka,kb", [
    (True, 4, 24, 384, 384), (False, 4, 24, 384, 384),
    (False, 16, 1, 384, 384),            # the verify launch (b per query)
    (True, 2, 3, 64, 1000),              # two column chunks
    # more CTAs than SMs, as on the scoring path: the odd query count
    # leaves the last CTA one query; an endurance sub-batch of 5 queries
    (True, 3, 140, 100, 7), (True, 5, 64, 384, 384),
    # the shared detector at 1,000 keypoints: the scoring launch (rows
    # spread over two CTAs a pair, two column chunks, best_a by global
    # atomicMin), the same with more slots than SMs, the verify launch
    (True, 4, 128, 1000, 1000), (True, 4, 140, 1000, 1000),
    (False, 8, 1, 1000, 1000)]
    + [(s, 3, 4 if s else 2, ka, kb) for s in (True, False)
       for ka, kb in EDGES])
def test_match_topk_kernel_matches_plain(gpu, shared, nq, cap, ka, kb):
    """The batched masked form, with ties across columns, rows and slots,
    invalid rows, columns, a whole invalid slot and query."""
    g = torch.Generator(device=gpu).manual_seed(int(shared) + ka + kb)
    a, av, b, bv = _match_inputs(g, nq, cap, ka, kb, shared, gpu)
    before = runtime.launches("k2")
    got = cuda_hamming.match_topk(a, av, b, bv, 10_000, 10_000)
    assert runtime.launches("k2") == before + 1
    want = cuda_hamming.match_topk_reference(a, av, b, bv, 10_000, 10_000)
    for g_, w, name in zip(got, want, ("d1", "i1", "d2", "best_a")):
        assert torch.equal(g_, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb", [(100, 7), (384, 384)])
def test_match_topk_kernel_with_a_small_big(gpu, ka, kb):
    """big (100) below the typical distance: masked entries compete with
    real ones, so the masked keys' index halves decide ties."""
    g = torch.Generator(device=gpu).manual_seed(ka + kb)
    a, av, b, bv = _match_inputs(g, 3, 4, ka, kb, True, gpu)
    got = cuda_hamming.match_topk(a, av, b, bv, 100, 100)
    want = cuda_hamming.match_topk_reference(a, av, b, bv, 100, 100)
    for g_, w, name in zip(got, want, ("d1", "i1", "d2", "best_a")):
        assert torch.equal(g_, w), name


@pytest.mark.cuda
def test_hamming_wrapper_rejects_bad_inputs(gpu):
    g = torch.Generator(device=gpu).manual_seed(0)
    a = _words(g, 2, 64, device=gpu)
    b = _words(g, 1, 3, 64, device=gpu)
    av = torch.ones(2, 64, dtype=torch.bool, device=gpu)
    bv = torch.ones(1, 3, 64, dtype=torch.bool, device=gpu)
    good = dict(a=a, a_valid=av, b=b, b_valid=bv, big=10_000, excl=10_000)
    bad = [("a", a.long(), TypeError), ("b", b.cpu(), ValueError),
           ("b", b.transpose(1, 2), ValueError),
           ("b", _words(g, 3, 3, 64, device=gpu), ValueError),
           ("a_valid", av.int(), TypeError), ("big", 1 << 15, ValueError),
           ("a", a.reshape(-1)[1:1 + 2 * 63 * 8].reshape(2, 63, 8),
            ValueError)]                        # not 16-byte aligned
    before = runtime.launches("k2")
    for name, val, exc in bad:
        with pytest.raises(exc):
            cuda_hamming.match_topk(**dict(good, **{name: val}))
    assert runtime.launches("k2") == before


@pytest.mark.cuda
def test_loop_detector_on_gpu_matches_cpu(gpu):
    """The capacity scenario (16 slots, 40 ingests, then a revisit) on the
    card and on the CPU: identical slot tables and message pairs, the
    revisit verified at the identity, and the kernel on the card's path."""
    cfg = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=32, ransac_iters=64),
        min_match_score=20, min_inliers=10, min_inlier_spread=0.3,
        keyframe_stride=0.0, min_time_separation=1e9, max_keyframes=16,
        match_chunk=8)
    rng = np.random.default_rng(7)

    def kp(dev, base=None):
        K = 32
        if base is None:
            base = (rng.integers(-2 ** 31, 2 ** 31, (K, 8), dtype=np.int64)
                    .astype(np.int32),
                    np.stack([rng.uniform(-2, 2, K), rng.uniform(-2, 2, K),
                              rng.uniform(1, 3, K)], -1).astype(np.float32))
        d, p = (torch.from_numpy(x).to(dev) for x in base)
        ones = torch.ones(K, dtype=torch.bool, device=dev)
        return ft.Keypoints(uv=torch.zeros(K, 2, device=dev),
                            response=ones.float(), valid=ones, desc=d,
                            p_cam=p, has_depth=ones), base

    dets = {dev: ld.LoopDetector(INTR, cfg, device=dev)
            for dev in ("cpu", gpu)}
    before = runtime.launches("k2")
    with pytest.warns(RuntimeWarning):
        for i in range(40):
            k_cpu, base = kp("cpu")
            k_gpu, _ = kp(gpu, base)
            msgs = [dets["cpu"].ingest_keypoints(i % 2, float(i), k_cpu),
                    dets[gpu].ingest_keypoints(i % 2, float(i), k_gpu)]
            assert [(m.from_client, m.from_time) for m in msgs[0]] == \
                [(m.from_client, m.from_time) for m in msgs[1]]
    assert runtime.launches("k2") > before
    tables = [[None if k is None else (k.client_id, k.t) for k in d.slots]
              for d in dets.values()]
    assert tables[0] == tables[1]
    k_cpu, base = kp("cpu")
    for dev, k in (("cpu", k_cpu), (gpu, kp(gpu, base)[0])):
        dets[dev].ingest_keypoints(0, 40.0, k)
        msgs = dets[dev].ingest_keypoints(1, 41.0, k)
        assert msgs and msgs[0].from_time == 40.0
        err = geo.se3_log(geo.relative(torch.from_numpy(msgs[0].T_from_to),
                                       geo.identity("cpu")))
        assert float(torch.linalg.norm(err)) < 0.05


# ---------------------------------------------------------------------------
# The serving half (plain torch on the card): the same small layer on the
# card and on the CPU, under the CPU parity tests' tolerances.
# ---------------------------------------------------------------------------


def _sphere_layer(device, seed=0):
    """A 4³-block sphere (8³ blocks, 0.1 m voxels) with seeded weights and
    colours, built on the CPU and copied to ``device``."""
    from coxgraph_tpu_torch.utils import interop

    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                            max_blocks=256, truncation=0.2)
    r = torch.arange(-2, 2, dtype=torch.int32)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                         -1).reshape(-1, 3)
    layer = vx.allocate_blocks(spec, vx.create_tsdf_layer(spec, "cpu"),
                               coords)
    n = int(layer.num_blocks)
    c = vx.voxel_centers_of_block(spec, layer.block_coords[:n])
    g = torch.Generator().manual_seed(seed)
    layer.sdf[:n] = (torch.linalg.norm(c - 0.03, dim=-1) - 0.45).reshape(
        n, -1).clamp(-spec.truncation, spec.truncation)
    layer.weight[:n] = 0.5 + 2.5 * torch.rand(n, 512, generator=g)
    layer.color[:n] = torch.rand(n, 3 * 512, generator=g)
    arrays = interop.layer_to_numpy(layer)
    return spec, layer, interop.layer_from_numpy(arrays, device)


@pytest.mark.cuda
def test_serving_mesh_on_gpu_matches_cpu(gpu):
    from coxgraph_tpu_torch.ops import mesh
    from coxgraph_tpu_torch.ops.mesh_incremental import IncrementalMesher

    spec, cpu_layer, gpu_layer = _sphere_layer(gpu)
    for quantize in (False, True):
        vc, cc = mesh.extract_mesh(spec, cpu_layer, quantize=quantize)
        vg, cg = mesh.extract_mesh(spec, gpu_layer, quantize=quantize)
        assert vg.shape == vc.shape and vc.shape[0] > 1000
        np.testing.assert_allclose(vg, vc, atol=1e-5, rtol=0)
        np.testing.assert_allclose(cg, cc, atol=1e-5, rtol=0)
    m = IncrementalMesher(spec, chunk=16, quantize=False, max_tris=256)
    m.full_rebuild(gpu_layer)
    assert m.buffer_growths >= 1
    assert np.array_equal(m.mesh()[0], mesh.extract_mesh(
        spec, gpu_layer, quantize=False)[0])
    upd = torch.zeros(spec.max_blocks, dtype=torch.bool)
    upd[5] = True
    for layer, dev in ((cpu_layer, "cpu"), (gpu_layer, gpu)):
        assert torch.equal(
            mesh.dirty_block_chunks(spec, layer, upd.to(dev), 4).cpu(),
            mesh.dirty_block_chunks(spec, cpu_layer, upd, 4))


@pytest.mark.cuda
def test_serving_esdf_and_merge_on_gpu_match_cpu(gpu):
    from coxgraph_tpu_torch.ops import esdf, merge

    spec, cpu_layer, gpu_layer = _sphere_layer(gpu)
    for full in (False, True):
        ecfg = esdf.EsdfConfig(max_distance=0.8, full_connectivity=full)
        ec = esdf.esdf_from_tsdf(spec, cpu_layer, ecfg)
        eg = esdf.esdf_from_tsdf(spec, gpu_layer, ecfg)
        assert torch.equal(eg.dist.cpu(), ec.dist)
        assert torch.equal(eg.observed.cpu(), ec.observed)
    dst_spec = dataclasses.replace(spec, max_blocks=512)
    q = geo.so3_exp(torch.tensor([0.1, -0.3, 0.2]))
    for T in (geo.identity("cpu"),
              torch.cat([q, torch.tensor([0.13, -0.07, 0.21])])):
        out = {}
        for dev, layer in (("cpu", cpu_layer), ("cuda", gpu_layer)):
            dst = vx.create_tsdf_layer(dst_spec, layer.sdf.device)
            out[dev] = merge.merge_layer_into_sized(
                dst_spec, dst, layer, T.to(layer.sdf.device), src_spec=spec)
        for name in ("block_index", "block_coords", "num_blocks"):
            assert torch.equal(getattr(out["cuda"], name).cpu(),
                               getattr(out["cpu"], name)), name
        for name in ("sdf", "weight", "color"):
            d = (getattr(out["cuda"], name).cpu()
                 - getattr(out["cpu"], name)).abs()
            assert float(d.max()) <= 1e-4, name


@pytest.fixture(scope="module")
def client_vga_submap():
    """Submap 0 of ``client_vga.serve`` after its first 300 frames, a whole
    submap (10 s at 30 Hz), stepped as the cell's driver steps them: the
    lap rendered with the cell's depth noise, the drifting odometry, 5 cm
    voxels, 16³ blocks, a 64³ grid, 8,192 blocks, 640×480; the pools cut
    to two submaps → (spec, layer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import copy

    from slambench.harness import core

    c = core.cell("client_vga.serve")
    cfg = copy.deepcopy(c["config"])
    cfg["mapper"]["max_submaps"] = 2
    d = c["driver"].Driver(cfg, c["traffic"], 1, torch.device("cuda", 0))
    d._inputs()
    d.mapper = d.sm.HostMapper(d.mcfg, device=d.device)
    for g in range(d.per_submap):
        d._frame(g)
    yield d.mcfg.spec, sm.get_layer(d.mapper.state.collection.layers, 0)
    del d
    torch.cuda.empty_cache()


def _esdf_test_layer(gpu, spec, coords, n_live, seed):
    """A layer of ``spec`` with ``coords`` allocated, seeded sdf in
    [-0.5, 0.5] m (some -0.0) and weights (a third of the voxels
    unobserved), then its watermark set to ``n_live``: block_index still
    names the slots from n_live up, which are dead."""
    layer = vx.allocate_blocks(spec, vx.create_tsdf_layer(spec, "cpu"),
                               coords)
    n = int(layer.num_blocks)
    g = torch.Generator().manual_seed(seed)
    v3 = spec.voxels_per_side ** 3
    layer.sdf[:n] = torch.rand(n, v3, generator=g) - 0.5
    layer.sdf[:n][torch.rand(n, v3, generator=g) < 0.01] = -0.0
    layer.weight[:n] = torch.where(torch.rand(n, v3, generator=g) < 1 / 3,
                                   0.0, 0.5 + torch.rand(n, v3, generator=g))
    layer.num_blocks.fill_(n_live)
    return vx.TsdfLayer(**{f.name: getattr(layer, f.name).to(gpu)
                           for f in dataclasses.fields(layer)})


def _block_cube(lo, hi):
    r = torch.arange(lo, hi, dtype=torch.int32)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


def _grid_shell(spec):
    """Every block on the grid's outer faces: their outward neighbours
    lie outside the grid."""
    c = _block_cube(-spec.half_grid, spec.half_grid)
    return c[((c == -spec.half_grid) | (c == spec.half_grid - 1)).any(-1)]


ESDF_CASES = {
    # spec (voxel, v, grid, max_blocks, truncation), blocks, live, config
    "grid_shell": ((0.1, 8, 6, 256, 0.2), "shell", None,
                   dict(max_distance=0.8)),              # 12 sweeps
    "dead_neighbours": ((0.1, 8, 6, 256, 0.2), "shell", 100,
                        dict(max_distance=0.5)),         # 9 sweeps
    "no_live_block": ((0.1, 8, 6, 256, 0.2), "shell", 0,
                      dict(max_distance=0.8)),
    "pool_full": ((0.1, 4, 16, 64, 0.2), "cube", None,
                  dict(max_distance=0.1, extra_iters=0)),    # 1 sweep
    "no_sweep": ((0.1, 5, 8, 64, 0.2), "cube", None,
                 dict(max_distance=0.3, extra_iters=-3)),
}


def _esdf_kernels_vs_plain(spec, layer, ecfg):
    """esdf_from_tsdf on the card (the kernels, 1 + n_iters launches, no
    host sync) ≡ the plain sweeps on the card, dist's bits and observed,
    every max_blocks row."""
    n_iters = esdf_ops.sweep_count(spec, ecfg)
    before = runtime.launches("esdf")
    e = _no_sync(lambda: esdf_ops.esdf_from_tsdf(spec, layer, ecfg))
    assert runtime.launches("esdf") - before == 1 + n_iters
    plain = esdf_ops._esdf_sweeps(spec, layer, ecfg)
    torch.cuda.synchronize()
    assert e.dist.shape == plain.dist.shape == (layer.max_blocks,
                                                 spec.voxels_per_side ** 3)
    assert torch.equal(e.dist.view(torch.int32), plain.dist.view(torch.int32))
    assert torch.equal(e.observed, plain.observed)
    return e


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("case", list(ESDF_CASES))
def test_esdf_kernels_match_plain(gpu, case, full):
    """The ESDF kernels ≡ the plain sweeps on the card, both
    connectivities: live blocks on the grid's outer faces; the same with
    the watermark cut to 100 of 152 blocks (neighbours at dead slots); no
    live block; a pool filled to max_blocks at 4³ blocks (fewer threads a
    CTA than neighbour slots) and one sweep; 5³ blocks and no sweep."""
    (vs, v, g, mb, tr), blocks, live, kw = ESDF_CASES[case]
    spec = vx.VoxelGridSpec(voxel_size=vs, voxels_per_side=v, grid_dim=g,
                            max_blocks=mb, truncation=tr)
    coords = _grid_shell(spec) if blocks == "shell" else _block_cube(-2, 2)
    layer = _esdf_test_layer(gpu, spec, coords,
                             len(coords) if live is None else live, seed=v)
    if case == "pool_full":
        assert len(coords) == mb
    e = _esdf_kernels_vs_plain(
        spec, layer, esdf_ops.EsdfConfig(full_connectivity=full, **kw))
    n = int(layer.num_blocks)
    if n:
        assert bool(e.observed[:n].any())
    assert not bool(e.observed[n:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_esdf_kernels_match_plain_at_client_vga(gpu, client_vga_submap,
                                                full):
    """client_vga's ESDF (8,192 × 16³, 4 m, 84 sweeps) of a submap of the
    cell's traffic (~800 live blocks, as a serve builds it) ≡ the plain
    sweeps, its band keeps the TSDF, and distances grow past it."""
    spec, layer = client_vga_submap
    n = int(layer.num_blocks)
    assert spec.max_blocks == 8192 and n >= 700, n
    ecfg = esdf_ops.EsdfConfig(max_distance=4.0, full_connectivity=full)
    e = _esdf_kernels_vs_plain(spec, layer, ecfg)
    band = e.observed & (layer.sdf.abs() < spec.truncation)
    assert torch.equal(e.dist[band], layer.sdf[band])
    # the sweeps carry the distance across the observed voxels of the
    # allocated band, which reach ~0.6 m from the surface
    assert float(e.dist[:n][e.observed[:n]].max()) > 2 * spec.truncation


@pytest.mark.cuda
def test_live_mesh_dropped_finish_on_gpu(gpu):
    """Dispatch, drop finish(), step, live_mesh: equal to full extraction
    on the card (the repair of the reference's lost dirty bits)."""
    from coxgraph_tpu_torch.ops import mesh

    cfg = sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8,
                              grid_dim=32, max_blocks=1024, truncation=0.3),
        integrator=tsdf.TsdfIntegratorConfig(max_touched_blocks=512),
        intrinsics=INTR, max_submaps=8, max_history=64,
        submap_interval=10.0)
    depths, colors, traj = _frames(gpu, 3)
    hm = sm.HostMapper(cfg, device=gpu)
    hm.step(depths[0], colors[0], traj[0], 0.0)
    hm.live_mesh(quantize=False)
    hm.step(depths[1], colors[1], traj[1], 0.1)
    hm.live_mesh_async(quantize=False)              # finish() dropped
    hm.step(depths[2], colors[2], traj[2], 0.2)
    v, c = hm.live_mesh(quantize=False)
    vf, cf = mesh.extract_mesh(cfg.spec, sm.get_layer(
        hm.state.collection.layers, 0), quantize=False)
    assert v.shape[0] > 0
    assert np.array_equal(v, vf) and np.array_equal(c, cf)


# ---------------------------------------------------------------------------
# The solve half (plain torch on the card): the card's solve against the
# CPU's on the same inputs, at the CPU parity tests' tolerances; the LM
# loops with any host sync an error.
# ---------------------------------------------------------------------------


def _no_sync(fn):
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _pose_err(a, b):
    """(max translation m, max rotation rad) between pose sets (N,7)."""
    a, b = a.double().cpu(), b.double().cpu()
    rot = geo.so3_log(geo.rotation(geo.relative(a, b))).norm(dim=-1)
    return (float((a[..., 4:] - b[..., 4:]).norm(dim=-1).max()),
            float(rot.max()))


def _drifted_chain(device, n=8, seed=0):
    """A seeded odometry chain with a biased drift, one loop closure
    n-1 → 0 and height priors, on ``device``."""
    from coxgraph_tpu_torch.solver import pose_graph as pg

    rng = np.random.default_rng(seed)
    xi = torch.from_numpy(np.concatenate(
        [rng.normal(0, 0.2, (n - 1, 3)), rng.normal(0, 0.5, (n - 1, 3))],
        axis=1).astype(np.float32))
    rels = geo.se3_exp(xi)
    gt = [geo.identity("cpu")]
    for k in range(n - 1):
        gt.append(geo.compose(gt[-1], rels[k]))
    gt = torch.stack(gt)
    drift = geo.se3_exp(torch.tensor([0.0, 0.0, 0.02, 0.05, 0.0, 0.03]))
    c = pg.RelPoseConstraints.empty(2 * n, "cpu")
    h = pg.HeightConstraints.empty(n, "cpu")
    init = [gt[0]]
    for k in range(n - 1):
        meas = geo.compose(rels[k], drift)
        c = c.add(k, k + 1, meas)
        init.append(geo.compose(init[-1], meas))
        h = h.add(k + 1, gt[k + 1, 6], 0.1)
    c = c.add(0, n - 1, geo.relative(gt[0], gt[n - 1]),
              10.0 * torch.eye(6))

    def on(x):
        return type(x)(**{f.name: getattr(x, f.name).to(device)
                          for f in dataclasses.fields(x)})

    return torch.stack(init).to(device), on(c), on(h)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "huber", "yaw_only", "heights"])
def test_pose_graph_on_gpu_matches_cpu(gpu, case):
    from coxgraph_tpu_torch.solver import pose_graph as pg

    cfg = pg.SolverConfig(iterations=15, huber_delta=0.3 * (case == "huber"),
                          yaw_only=case == "yaw_only")
    out = {}
    for dev in ("cpu", gpu):
        init, c, h = _drifted_chain(dev)
        hh = h if case == "heights" else None
        run = lambda: pg.optimize(init, c, cfg, heights=hh)   # noqa: E731
        out[str(dev)] = _no_sync(run) if dev == gpu else run()
    g, cp = out[str(gpu)], out["cpu"]
    dt, dr = _pose_err(g.poses, cp.poses)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    assert abs(float(g.cost) - float(cp.cost)) <= 1e-4 * max(
        float(cp.cost), 1e-6)
    assert float(cp.cost) < float(cp.initial_cost)


def _registration_layers(device):
    """Two overlapping submaps of the synthetic room (the setting of
    tests/test_registration.py, 160×120, 0.1 m voxels), integrated on the
    card, and their CPU copies."""
    from coxgraph_tpu_torch.utils import interop

    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                            max_blocks=2048, truncation=0.3)
    icfg = tsdf.TsdfIntegratorConfig(max_touched_blocks=1024)
    intr = syn.PinholeIntrinsics().scaled(0.25)
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(8, scene.room_center, radius=2.5,
                                sweep=np.pi)
    out = []
    for lo, hi, anchor in ((0, 5, 0), (3, 8, 4)):
        layer = vx.create_tsdf_layer(spec, device)
        for i in range(lo, hi):
            d, c = syn.render_depth(scene, intr, traj[i])
            tsdf.integrate_frame(spec, icfg, intr, layer, d, c,
                                 geo.relative(traj[anchor], traj[i]))
        out.append((layer, interop.layer_from_numpy(
            interop.layer_to_numpy(layer), "cpu")))
    T_true = geo.relative(traj[0], traj[4])
    return spec, out, T_true


@pytest.mark.cuda
def test_registration_on_gpu_matches_cpu(gpu):
    from coxgraph_tpu_torch.ops import registration as reg

    spec, ((ga, ca), (gb, cb)), T_true = _registration_layers(gpu)
    rcfg = reg.RegistrationConfig(max_points=1024, iterations=15)
    pert = geo.se3_exp(torch.tensor([0.02, -0.015, 0.03, 0.06, -0.04,
                                     0.05], device=gpu))
    T_init = geo.compose(T_true, pert)
    cache = {dev: reg.surface_point_cache(spec, la, rcfg)
             for dev, la in (("cpu", ca), ("cuda", ga))}
    (pg_, sg, mg), (pc, sc, mc) = cache["cuda"], cache["cpu"]
    assert torch.equal(pg_.cpu(), pc) and torch.equal(mg.cpu(), mc)
    assert float((sg.cpu() - sc).abs().max()) <= 1e-6
    Tc = T_init.cpu()
    Hc, bc, cc, nc = reg.registration_normal_eq(
        spec, cb, *cache["cpu"], geo.identity("cpu"), Tc)
    Hg, bg, cg, ng = reg.registration_normal_eq(
        spec, gb, *cache["cuda"], geo.identity(gpu), T_init)
    assert int(ng) == int(nc) > 100
    assert float((Hg.cpu() - Hc).abs().max()) <= 1e-4 * float(
        Hc.abs().max())
    assert float((bg.cpu() - bc).abs().max()) <= 1e-4 * float(
        bc.abs().max())
    before = runtime.launches("reg")
    rg = _no_sync(lambda: reg.register_pair(spec, ga, gb, T_init, rcfg))
    assert runtime.launches("reg") - before == rcfg.iterations + 2
    rc = reg.register_pair(spec, ca, cb, Tc, rcfg)
    dt, dr = _pose_err(rg.T_A_B[None], rc.T_A_B[None])
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    assert int(rg.n_inliers) > 200
    assert float(rg.cost) < float(rg.initial_cost)


@pytest.mark.cuda
def test_two_phase_on_gpu_matches_cpu(gpu):
    """8 submaps of the bench solve point: poses, pairs and the cost
    trace; the chunked phase 2 on the card against its fused run."""
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.server import global_opt as go

    out = {}
    for dev, di in (("cpu", 0), ("cuda", 0), ("cuda", 2)):
        init, cons, layers, spec, rcfg, scfg, fixed = \
            bm.solve_benchmark_problem(8, device=torch.device(dev))
        rcfg = dataclasses.replace(rcfg, phase2_dispatch_iters=di)
        before = runtime.launches("reg")
        out[(dev, di)] = go.optimize_two_phase(
            init, cons, spec, layers, reg_cfg=rcfg, solver_cfg=scfg,
            registration_weight=30.0, reg_iterations=6, fixed=fixed)
        # the kernel twice an iteration (assemble, the trial's cost), once
        # for the final cost; never on the CPU
        assert runtime.launches("reg") - before == (13 if dev == "cuda"
                                                    else 0)
    pc, ic = out[("cpu", 0)]
    for key in (("cuda", 0), ("cuda", 2)):
        pg_, ig = out[key]
        assert ig["n_registration_pairs"] == ic["n_registration_pairs"]
        dt, dr = _pose_err(pg_, pc)
        assert dt <= 1e-4 and dr <= 1e-4, (key, dt, dr)
        np.testing.assert_allclose(ig["phase2_cost_trace"],
                                   ic["phase2_cost_trace"], rtol=1e-4)


def _reg_kernel_vs_plain(spec, sdf, w, bi, pair_j, pts, sdfA, maskA, TA,
                         TB, delta=0.1):
    """The registration kernel (``cuda_registration.pair_terms`` on the
    card, one launch, no host sync) against the plain composition on the
    card over the same lookup: n_valid exact, H and b within 1e-5 of each
    pair's max |·|, cost within 1e-5 relative (the sums' order alone
    differs); a second call and the cost-only form repeat its bits."""
    from coxgraph_tpu_torch.ops import cuda_registration as creg
    from coxgraph_tpu_torch.ops import registration as reg

    args = (spec, sdf, w, bi, pair_j, pts, sdfA, maskA, TA, TB, delta)
    before = runtime.launches("reg")
    got = _no_sync(lambda: creg.pair_terms(*args))
    again = creg.pair_terms(*args)
    part = creg.pair_terms(*args, cost_only=True)
    assert runtime.launches("reg") - before == 3
    R = sdf.shape[0] // bi.shape[0]
    want = reg.pair_terms(spec, sdf, w, reg.stacked_slots(spec, bi, pair_j,
                                                           R),
                          pts, sdfA, maskA, TA, TB, delta)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert part[0] is None and part[1] is None
    assert torch.equal(part[2], got[2]) and torch.equal(part[3], got[3])
    H, b, cost, n = got
    Hw, bw, cw, nw = want
    assert H.shape == Hw.shape and n.dtype == torch.int32
    assert torch.equal(n, nw)
    lead = H.shape[:-2]
    dH = (H - Hw).abs().reshape(lead + (-1,)).amax(-1)
    db = (b - bw).abs().amax(-1)
    assert bool((dH <= 1e-5 * Hw.abs().reshape(lead + (-1,)).amax(-1)).all())
    assert bool((db <= 1e-5 * bw.abs().amax(-1)).all())
    assert bool(((cost - cw).abs() <= 1e-5 * cw.abs()).all())
    return got


@pytest.mark.cuda
def test_registration_kernel_matches_plain_on_solve_pairs(gpu):
    """Every overlapping pair of 8 submaps of the bench solve problem at
    Q = 2,048 points, from the drifted start nudged per submap, over the
    stacked field at R = 48 of 64 rows (the rest fall out of the
    sampling)."""
    from coxgraph_tpu_torch.eval import benchmarks as bm
    from coxgraph_tpu_torch.ops import registration as reg
    from coxgraph_tpu_torch.server import global_opt as go

    init, _, layers, spec, rcfg, _, _ = bm.solve_benchmark_problem(
        8, device=gpu)
    rcfg = dataclasses.replace(rcfg, max_points=2048)
    pairs = go.find_overlapping_pairs(spec, layers, init)
    rp = go.make_registration_pairs(spec, layers, pairs, rcfg)
    ij = torch.tensor(pairs, dtype=torch.int64, device=gpu).T.contiguous()
    sdf, w, bi = go._stack_fields(layers, 48)
    g = torch.Generator().manual_seed(11)
    poses = geo.compose(init, geo.se3_exp(
        0.02 * torch.randn(8, 6, generator=g)).to(gpu))
    H, _, _, n = _reg_kernel_vs_plain(
        spec, sdf, w, bi, ij[1].contiguous(),
        torch.stack([p.pts_i for p in rp]),
        torch.stack([p.sdf_i for p in rp]),
        torch.stack([p.mask_i for p in rp]), poses[ij[0]], poses[ij[1]],
        rcfg.huber_delta)
    assert len(pairs) >= 10 and int(n.max()) > 500
    assert torch.equal(H, H.transpose(-1, -2))


@pytest.mark.cuda
@pytest.mark.parametrize("vps", [5, 8])
def test_registration_kernel_matches_plain_at_the_edges(gpu, vps):
    """Two submaps of 40 random blocks in a 4³-block cube of an 8³ grid
    (5³ and 8³ voxels a block), 5% of the voxels unobserved (w = 0);
    points in a box past the cube's faces (many in missing blocks), 64 a
    pair three times as far (most outside the grid), a fifth masked off;
    pair 3 wholly masked (n = 0: H, b and cost 0). Then the S = 1 form, ``registration_normal_eq``,
    against the plain terms over ``vx.lookup_block``."""
    from coxgraph_tpu_torch.ops import registration as reg
    from coxgraph_tpu_torch.server import global_opt as go

    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=vps, grid_dim=8,
                            max_blocks=40, truncation=0.2)
    g = torch.Generator().manual_seed(vps)
    cube = _block_cube(-2, 2)
    layers = []
    for _ in range(2):
        layer = vx.allocate_blocks(spec, vx.create_tsdf_layer(spec, "cpu"),
                                   cube[torch.randperm(len(cube),
                                                       generator=g)[:40]])
        shape = layer.sdf.shape
        layer.sdf = torch.rand(shape, generator=g) - 0.5
        layer.weight = torch.where(torch.rand(shape, generator=g) < 0.05,
                                   0.0, 0.5 + torch.rand(shape, generator=g))
        layers.append(vx.TsdfLayer(**{
            f.name: getattr(layer, f.name).to(gpu)
            for f in dataclasses.fields(layer)}))
    sdf, w, bi = go._stack_fields(layers, 40)
    P, Q = 6, 777
    # 1.2 × the allocated cube's half width; the first 64 points 3× that,
    # mostly outside the grid
    extent = 0.1 * vps * 2 * 1.2
    pts = (torch.rand(P, Q, 3, generator=g) * 2 - 1) * extent
    pts[:, :64] *= 3.0
    pts = pts.to(gpu)
    sdfA = (torch.rand(P, Q, generator=g) - 0.5).to(gpu)
    maskA = torch.rand(P, Q, generator=g) < 0.8
    maskA[3] = False
    pair_j = (torch.arange(P) % 2).to(gpu)
    T = geo.se3_exp(torch.cat([0.3 * torch.randn(2 * P, 3, generator=g),
                               0.2 * torch.randn(2 * P, 3, generator=g)],
                              -1)).to(gpu)
    H, b, cost, n = _reg_kernel_vs_plain(spec, sdf, w, bi, pair_j, pts,
                                         sdfA, maskA.to(gpu), T[:P], T[P:])
    assert int(n[3]) == 0 and float(cost[3]) == 0.0
    assert not bool(H[3].any()) and not bool(b[3].any())
    assert int(n.sum()) > 100

    layer = layers[1]
    args = (pts[0], sdfA[0], maskA[0].to(gpu), T[0], T[P])
    before = runtime.launches("reg")
    got = _no_sync(lambda: reg.registration_normal_eq(spec, layer, *args))
    assert runtime.launches("reg") - before == 1
    want = reg.pair_terms(spec, layer.sdf, layer.weight,
                          lambda c: vx.lookup_block(spec, layer, c), *args,
                          0.1)
    assert int(got[3]) == int(want[3]) > 10
    for x, y in zip(got[:2], want[:2]):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
    assert abs(float(got[2]) - float(want[2])) <= 1e-5 * float(want[2])


def _small_servers(gpu, height=0.0, **kw):
    """The small two-client world of tests/test_server.py (orbits raised
    by ``height``), built by the port on the CPU and carried to the card
    with utils.interop → (trajs, {"cpu": server, "cuda": server})."""
    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.server import fusion_server as fs
    from coxgraph_tpu_torch.server.client_interface import InProcessClient
    from coxgraph_tpu_torch.utils import interop

    trajs, _, cpu_clients = demos.small_two_client_world("cpu", height)
    cfg, scfg = demos.small_world_configs()
    scfg = dataclasses.replace(scfg, **kw)
    gpu_clients = [InProcessClient(c.client_id, cfg,
                                   interop.mapper_state_from(c.state, gpu))
                   for c in cpu_clients]
    return trajs, {"cpu": fs.CoxgraphServer(scfg, cpu_clients, "cpu"),
                   "cuda": fs.CoxgraphServer(scfg, gpu_clients, gpu)}


@pytest.mark.cuda
@pytest.mark.parametrize("height,kw", [(0.0, {"registration_weight": 0.0}),
                                       (0.3, {})],
                         ids=["level_no_registration", "raised"])
def test_server_optimize_on_gpu_matches_cpu(gpu, height, kw):
    """Two fusions through the server on the card and on the CPU: the
    bookkeeping exact, T_G_cli and the submap poses within 1e-4. The test
    world's level orbits put the registration samples on the voxel
    lattice, where the card and the CPU may take another trilinear cell
    (ROADMAP queue 3), so registration is held on the orbits raised by
    0.3 m (observed 2.3e-6 m) and the level world without it (1.0e-6)."""
    from coxgraph_tpu_torch.eval import demos

    trajs, servers = _small_servers(gpu, height, **kw)
    for ta, tb in ((3, 3), (6, 5)):
        for s in servers.values():
            assert s.map_fusion(demos.true_fusion(trajs, ta, tb))
    c, g = servers["cpu"], servers["cuda"]
    assert g.cli_ser == c.cli_ser and g.constraint_kinds == c.constraint_kinds
    poses = [np.stack([s.T_G_submap for s in x.submaps]) for x in (g, c)]
    dt, dr = _pose_err(torch.from_numpy(poses[0]), torch.from_numpy(poses[1]))
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    for cid in (0, 1):
        dt, dr = _pose_err(torch.from_numpy(g.T_G_cli[cid][None]),
                           torch.from_numpy(c.T_G_cli[cid][None]))
        assert dt <= 1e-4 and dr <= 1e-4, (cid, dt, dr)
    assert g.optimize_errors == [] == c.optimize_errors


@pytest.mark.cuda
def test_fusion_with_control_off_does_not_sync(gpu):
    """A fusion between submaps the server holds runs no host sync with
    the solve off (the first one pulls its submaps from the clients)."""
    from coxgraph_tpu_torch.eval import demos

    trajs, servers = _small_servers(gpu)
    g = servers["cuda"]
    g.control_trigger(False)
    assert g.map_fusion(demos.true_fusion(trajs, 3, 3))
    torch.cuda.synchronize()
    assert _no_sync(lambda: g.map_fusion(demos.true_fusion(trajs, 3, 3)))
    assert g.constraint_kinds.count("fusion") == 2


@pytest.mark.cuda
def test_final_mesh_on_gpu_matches_cpu(gpu):
    """get_final_global_mesh at given poses (control off, no solve; one
    generic change of the global frame keeps the voxel axes off the
    lattice): merged integers and triangle count exact, pools within 1e-4,
    vertices within one uint16 quantum plus one f32 rounding."""
    from coxgraph_tpu_torch.eval import demos

    trajs, servers = _small_servers(gpu)
    frame = np.concatenate([
        geo.so3_exp(torch.tensor([0.031, -0.017, 0.113])).numpy(),
        [0.0123, -0.0371, 0.0217]]).astype(np.float32)
    out = {}
    for dev, s in servers.items():
        s.control_trigger(False)
        assert s.map_fusion(demos.true_fusion(trajs, 3, 3))
        s.collect_all_submaps()
        for sm_ in s.submaps:
            sm_.T_G_submap = geo.compose_np(frame, sm_.T_G_submap
                                            ).astype(np.float32)
        out[dev] = s.get_final_global_mesh()
    (mc, vc, cc), (mg, vg, cg) = out["cpu"], out["cuda"]
    for name in ("block_index", "block_coords", "num_blocks"):
        assert torch.equal(getattr(mg, name).cpu(), getattr(mc, name))
    for name in ("sdf", "weight", "color"):
        d = (getattr(mg, name).cpu() - getattr(mc, name)).abs()
        assert float(d.max()) <= 1e-4, name
    n = int(mc.num_blocks)
    bc = mc.block_coords[:n].numpy()
    spec = servers["cpu"].cfg.spec
    lsb = float(((bc.max(0) + 1 - bc.min(0)) * spec.block_size).max()
                ) / 65535.0
    assert vg.shape == vc.shape and vc.shape[0] > 500
    assert np.abs(vg - vc).max() <= lsb + 1e-6
    assert np.abs(cg - cc).max() <= 1.0 / 255 + 1e-6


@pytest.mark.cuda
def test_sharded_final_mesh_on_gpu_matches_cpu(gpu):
    """get_final_global_mesh(device_mesh=…) on the card (a world-size-1
    NCCL group) and on the CPU (a gloo group beside it), on the world and
    poses of the test above: merged integers and triangle count exact,
    pools within 1e-4, vertices within one uint16 quantum of the live
    blocks' extent (the unquantized meshes' tolerance of the test above),
    colours within 1e-4."""
    import torch.distributed as dist

    from coxgraph_tpu_torch.eval import demos
    from coxgraph_tpu_torch.parallel import fleet as fl
    from coxgraph_tpu_torch.parallel import multihost

    trajs, servers = _small_servers(gpu)
    frame = np.concatenate([
        geo.so3_exp(torch.tensor([0.031, -0.017, 0.113])).numpy(),
        [0.0123, -0.0371, 0.0217]]).astype(np.float32)
    out = {}
    with multihost.single_process(gpu):
        meshes = {"cuda": fl.make_robot_mesh(device=gpu),
                  "cpu": fl.make_robot_mesh(device="cpu", group=dist.new_group(
                      backend="gloo"))}
        for dev, s in servers.items():
            s.control_trigger(False)
            assert s.map_fusion(demos.true_fusion(trajs, 3, 3))
            s.collect_all_submaps()
            for sm_ in s.submaps:
                sm_.T_G_submap = geo.compose_np(frame, sm_.T_G_submap
                                                ).astype(np.float32)
            out[dev] = s.get_final_global_mesh(device_mesh=meshes[dev])
    (mc, vc, cc), (mg, vg, cg) = out["cpu"], out["cuda"]
    for name in ("block_index", "block_coords", "num_blocks"):
        assert torch.equal(getattr(mg, name).cpu(), getattr(mc, name))
    for name in ("sdf", "weight", "color"):
        d = (getattr(mg, name).cpu() - getattr(mc, name)).abs()
        assert float(d.max()) <= 1e-4, name
    n = int(mc.num_blocks)
    bc = mc.block_coords[:n].numpy()
    spec = servers["cpu"].cfg.spec
    lsb = float(((bc.max(0) + 1 - bc.min(0)) * spec.block_size).max()
                ) / 65535.0
    assert vg.shape == vc.shape and vc.shape[0] > 500
    assert np.abs(vg - vc).max() <= lsb
    assert np.abs(cg - cc).max() <= 1e-4


@pytest.mark.cuda
def test_fleet_step_on_gpu_matches_cpu(gpu):
    """Two robots, three fleet steps (rollovers at t = 0 and 0.2) at 80×60
    into 8³ blocks, on the card without a host sync and on the CPU, the
    same frames: integers exact, poses within 1e-6, pools with the share
    of |Δ| > 1e-4 below 1e-3 (this file's card-vs-CPU tolerance)."""
    from coxgraph_tpu_torch.parallel import fleet as fl
    from coxgraph_tpu_torch.parallel import multihost
    from coxgraph_tpu_torch.utils import interop

    R = 2
    cfg = sm.MapperConfig(spec=_spec(8), integrator=CFG, intrinsics=INTR,
                          max_submaps=4, max_history=16,
                          submap_interval=0.2, max_constraints=16)
    scene = syn.default_scene("cpu")
    trajs = torch.stack([syn.orbit_trajectory(
        3, scene.room_center, radius=2.5, sweep=0.3 * np.pi,
        start_angle=np.pi * r) for r in range(R)], 1)         # (3,R,7)
    frames = [[syn.render_depth(scene, INTR, trajs[f, r]) for r in range(R)]
              for f in range(3)]
    states = {}
    with multihost.single_process(gpu):
        for dev in ("cpu", gpu):
            mesh = fl.make_robot_mesh(R, dev)
            fleet = fl.shard_fleet(fl.create_fleet(cfg, R, dev), mesh)
            for f in range(3):
                args = (torch.stack([d for d, _ in frames[f]]).to(dev),
                        torch.stack([c for _, c in frames[f]]).to(dev),
                        trajs[f].to(dev), torch.full((R,), 0.1 * f).to(dev))
                if dev == gpu:
                    torch.cuda.synchronize()
                    assert _no_sync(lambda: fl.fleet_step(cfg, mesh, fleet,
                                                          *args))
                else:
                    fl.fleet_step(cfg, mesh, fleet, *args)
            states[str(dev)] = interop.fleet_to_numpy(fleet)
    c, g = states["cpu"], states[str(gpu)]
    assert int(c["collection.num_submaps"].min()) == 2
    for k, a in c.items():
        b = g[k]
        if k.startswith("collection.layers.") and a.dtype == np.float32:
            assert (np.abs(b - a) > 1e-4).mean() < 1e-3, k
        elif a.dtype == np.float32:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# ---------------------------------------------------------------------------
# Transports and point clouds (wire, mesh with history, ops.points)
# ---------------------------------------------------------------------------


def _card_and_cpu_layer(gpu, spec):
    """The same two frames integrated into a layer on the card and on the
    CPU → (card layer, CPU layer)."""
    out = []
    for device in (gpu, torch.device("cpu")):
        depths, colors, traj = _frames(device)
        layer = vx.create_tsdf_layer(spec, device)
        for f in range(2):
            tsdf.integrate_frame(spec, CFG, INTR, layer, depths[f],
                                 colors[f], traj[f])
        out.append(layer)
    return out


@pytest.mark.cuda
def test_wire_round_trip_of_a_card_layer(gpu):
    """A card layer serializes to the bytes of its CPU copy (one read of
    its live rows), and bytes decode onto the card bit for bit as onto the
    CPU: rows, coords, block index and slot order."""
    from coxgraph_tpu_torch.comm import wire

    spec = _spec(8)
    card, _ = _card_and_cpu_layer(gpu, spec)
    cpu_copy = vx.TsdfLayer(**{f.name: getattr(card, f.name).cpu()
                               for f in dataclasses.fields(card)})
    buf = wire.serialize_layer(spec, card)
    assert buf == wire.serialize_layer(spec, cpu_copy)
    a = wire.deserialize_layer(spec, buf, gpu)
    b = wire.deserialize_layer(spec, buf, torch.device("cpu"))
    for f in dataclasses.fields(a):
        assert getattr(a, f.name).is_cuda
        assert torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name))


@pytest.mark.cuda
def test_render_points_on_gpu_matches_cpu(gpu):
    """Depth (a per-pixel min) and colour (the least-z, then lowest-index
    point) are exact, with many points per pixel and exact z ties."""
    from coxgraph_tpu_torch.comm import mesh_comm

    g = torch.Generator().manual_seed(0)
    n = 20_000
    pts = torch.rand((n, 3), generator=g) * torch.tensor([2.0, 1.5, 3.0]) \
        - torch.tensor([1.0, 0.75, -0.2])
    pts[:n // 2, 2] = pts[n // 2:, 2]                    # exact z ties
    cols = torch.rand((n, 3), generator=g)
    want = mesh_comm.render_points(INTR, pts, cols)
    got = mesh_comm.render_points(INTR, pts.to(gpu), cols.to(gpu))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert int((want[0] > 0).sum()) > 1000


@pytest.mark.cuda
def test_step_points_on_gpu_matches_cpu(gpu):
    """HostMapper.step_points over four clouds on the card ≡ on the CPU:
    the block set, slots and bookkeeping exact; every observed voxel's
    weight within 1e-3·(1 + w), and at most 1e-3 of them beyond
    1e-5·(1 + w); sdf within 1e-4 and colour within 5e-5 wherever both
    observed the voxel. index_add_'s atomics sum the bundles and the
    samples in another order on the card (weights reach 1,200 here).
    Measured on an H100 in three repeats, the same each time: at most
    3.6e-4·(1 + w) (6.7e-3 absolute), 1.8e-4 of the voxels beyond
    1e-5·(1 + w), none observed on one side only; sdf at most 3.8e-5
    and colour 1.7e-5 apart."""
    from coxgraph_tpu_torch.ops import points as pts_ops

    spec = _spec(8)
    cfg = sm.MapperConfig(spec=spec, integrator=dataclasses.replace(
        CFG, max_touched_blocks=128), intrinsics=INTR, max_submaps=4,
        max_history=16, submap_interval=0.15)
    states = []
    for device in (gpu, torch.device("cpu")):
        scene = syn.default_scene(device)
        traj = syn.orbit_trajectory(4, scene.room_center, radius=2.5,
                                    sweep=0.3 * np.pi)
        hm = sm.HostMapper(cfg, device=device)
        for i in range(4):
            d, c = syn.render_depth(scene, INTR, traj[i])
            p = pts_ops.backproject(INTR, d).reshape(-1, 3)
            hm.step_points(p, c.reshape(-1, 3), d.reshape(-1) > 0.1,
                           traj[i].cpu().numpy(), 0.1 * i)
        states.append(hm.state)
    a, b = (s.collection.layers for s in states)
    for name in ("block_index", "block_coords", "num_blocks"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name))
    assert torch.equal(states[0].mesh_dirty.cpu(), states[1].mesh_dirty)
    aw = a.weight.cpu()
    dw = (aw - b.weight).abs()
    obs = (aw > 0) | (b.weight > 0)
    assert bool((dw <= 1e-3 * (1 + b.weight))[obs].all()), float(
        (dw / (1 + b.weight))[obs].max())
    assert float((dw > 1e-5 * (1 + b.weight))[obs].float().mean()) <= 1e-3
    both = (aw > 0) & (b.weight > 0)
    assert float((a.sdf.cpu() - b.sdf).abs()[both].max()) <= 1e-4
    v3 = aw.shape[-1]
    dc = (a.color.cpu() - b.color).abs().reshape(aw.shape[:-1] + (3, v3))
    assert float(dc.amax(-2)[both].max()) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["projective", "merged"])
def test_recover_layer_on_gpu_matches_cpu(gpu, method):
    """A mesh message recovered on the card ≡ on the CPU: the block set
    exact, sdf and weight within 5e-3 wherever both observed (measured on
    an H100: "projective" equal; "merged" at most 2.9e-6 and 3.3e-4, with
    weights up to 119)."""
    from coxgraph_tpu_torch.comm import mesh_comm

    spec = _spec(8)
    _, layer = _card_and_cpu_layer(gpu, spec)
    traj = _frames(torch.device("cpu"))[2].numpy()
    msg = mesh_comm.encode_submap_mesh(spec, layer, np.array([0.0, 0.05]),
                                       traj, INTR, keyframe_stride=1)
    got, want = (mesh_comm.recover_layer(spec, CFG, INTR, msg, method=method,
                                         device=d)
                 for d in (gpu, torch.device("cpu")))
    for name in ("block_index", "block_coords", "num_blocks"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    both = (got.weight.cpu() > 0) & (want.weight > 0)
    assert int(both.sum()) > 1000
    for name in ("sdf", "weight"):
        d = (getattr(got, name).cpu() - getattr(want, name)).abs()[both]
        assert float(d.max()) < 5e-3, (name, float(d.max()))


@pytest.mark.cuda
def test_endurance_lap_on_gpu(gpu):
    """One lap of the endurance mission on the card (its own
    configuration, burst, 2 robots × 96 frames), its four threads sharing
    the card: every gate of the mission, K1 once per integrated frame,
    K2 launched."""
    from coxgraph_tpu_torch.eval import endurance as en

    k1, k2 = runtime.launches("k1"), runtime.launches("k2")
    art = en.endurance_run(gpu, laps=1, out=None, log=None)
    assert art["ok"], (art["gates"], art["optimize_errors"])
    assert runtime.launches("k1") - k1 == sum(art["integrated_frames"]) \
        == 2 * en.N_LAP
    assert art["mapper_windows"] == [en.N_LAP // en.WINDOW] * 2
    assert runtime.launches("k2") - k2 >= 1


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _real_frame(index: int, device):
    """tum_real frame ``index`` decoded on the host → (depth, colour, T)
    on ``device``, and its share of depth holes."""
    from coxgraph_tpu_torch.frontends import replay

    _, rgb, dep, T = replay.TumRgbdReplay(
        os.path.join(FIXTURES, "tum_real"), device=device).associations()[
            index]
    depth = replay.read_png(dep).astype(np.float32) / 5000.0
    color = replay.read_png(rgb)[..., :3].astype(np.float32) / 255.0
    return ((torch.from_numpy(depth).to(device),
             torch.from_numpy(color).to(device), torch.from_numpy(T).to(
                 device)), float((depth == 0).mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("point", ["tum_loop", "tum_real"])
def test_drift_correction_gates_on_gpu(gpu, point):
    """The JAX drift tests' flows on the card (tests/test_tum_replay.py,
    tests/test_real_replay.py): every gate, K1 once a frame, K2 on the
    detector's path, the mapper's pose mirror equal to the device's."""
    from coxgraph_tpu_torch.eval import demos

    k1, k2 = runtime.launches("k1"), runtime.launches("k2")
    r = demos.drift_correction(os.path.join(FIXTURES, point), point, gpu)
    assert r["ok"], {k: r[k] for k in ("closures", "routed", "ate_drifted",
                                       "ate_corrected", "mirror_err")}
    assert runtime.launches("k1") - k1 == r["k1_launches"] == r["frames"] \
        == 144
    assert runtime.launches("k2") - k2 == r["k2_launches"] > 0


@pytest.mark.cuda
def test_tum_pipeline_on_gpu_matches_cpu(gpu):
    """tum_tiny through tum_pipeline on the card and on the CPU: the same
    submaps, the trajectory within 1e-6, both within the JAX test's
    gates, the mesh's surface q90 within 1 mm and its vertex count within
    1%."""
    from coxgraph_tpu_torch.eval import demos

    root = os.path.join(FIXTURES, "tum_tiny")
    got = demos.tum_pipeline(root, gpu)
    want = demos.tum_pipeline(root, torch.device("cpu"))
    assert got["ok"] and want["ok"]
    assert got["submaps"] == want["submaps"] >= 2
    np.testing.assert_allclose(got["stamps"], want["stamps"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-6,
                               rtol=0)
    assert abs(got["surf_q90"] - want["surf_q90"]) < 1e-3
    assert abs(got["vertices"] - want["vertices"]) <= 0.01 * want["vertices"]


@pytest.mark.cuda
def test_kernel_matches_twin_on_real_depth_with_holes(gpu):
    """K1 ≡ its twin on two tum_real frames whose depth has dropout and
    speckle holes, at the drift tests' mapper (1,024 blocks of 8³, 512
    lanes), fresh pools then pools with weight."""
    from coxgraph_tpu_torch.eval import demos

    cfg = demos.tum_real_config()[0]
    spec, icfg, intr = cfg.spec, cfg.integrator, cfg.intrinsics
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    lk, lt = _stacked(spec, gpu), _stacked(spec, gpu)
    marks = cuda_alloc.new_marks(spec, gpu)
    for index in (0, 60):
        (depth, color, T), holes = _real_frame(index, gpu)
        assert holes > 0.001, holes
        sk, mk = cuda_alloc.alloc_pass(spec, icfg, intr, lk, k, depth, T,
                                       None, marks)
        st, mt = cuda_alloc.alloc_pass_reference(spec, icfg, intr, lt, k,
                                                 depth, T)
        assert torch.equal(sk, st) and torch.equal(mk, mt)
        args = (k, sk, mk, depth, color.permute(2, 0, 1).contiguous(),
                geo.inverse(T).contiguous())
        before = runtime.launches("k1")
        cuda_tsdf.update_blocks(spec, icfg, intr, lk, *args)
        assert runtime.launches("k1") == before + 1
        cuda_tsdf.update_blocks_reference(spec, icfg, intr, lt, *args)
        torch.cuda.synchronize()
        assert int((lt.weight > 0).sum()) > 10_000
        for f_ in dataclasses.fields(lk):
            assert torch.equal(getattr(lk, f_.name),
                               getattr(lt, f_.name)), f_.name


@pytest.mark.cuda
def test_hamming_kernel_matches_plain_on_real_descriptors(gpu):
    """K2 ≡ its plain version on every output at the tum_real detector's
    launches: 4 real keyframes' descriptors (K = 512) in a
    ``match_chunk``-slot chunk (128), one query per scoring launch, and
    the verify launch (b per query)."""
    from coxgraph_tpu_torch.eval import demos

    cfg, det_cfg, _ = demos.tum_real_config()
    kps = [ft.detect_and_describe(cfg.intrinsics, c, d, det_cfg.features)
           for (d, c, _), _ in (_real_frame(i, gpu) for i in (0, 40, 80,
                                                             120))]
    slots, K = det_cfg.match_chunk, det_cfg.features.max_keypoints
    desc = torch.zeros((slots, K, 8), dtype=torch.int32, device=gpu)
    valid = torch.zeros((slots, K), dtype=torch.bool, device=gpu)
    for s, kp in enumerate(kps):
        desc[s], valid[s] = kp.desc, kp.valid
    assert int(valid.sum()) > 100
    cases = [(kp.desc[None], kp.valid[None], desc[None], valid[None])
             for kp in kps]
    cases.append((desc[:3], valid[:3], desc[1:4, None].contiguous(),
                  valid[1:4, None].contiguous()))
    for a, av, b, bv in cases:
        before = runtime.launches("k2")
        got = cuda_hamming.match_topk(a, av, b, bv, 10_000, 10_000)
        assert runtime.launches("k2") == before + 1
        want = cuda_hamming.match_topk_reference(a, av, b, bv, 10_000,
                                                 10_000)
        for g_, w, name in zip(got, want, ("d1", "i1", "d2", "best_a")):
            assert torch.equal(g_, w), name
