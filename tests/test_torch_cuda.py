"""GPU tests of the port's CUDA kernel (marker ``cuda``; each skips
without a card). The machine with the card has no JAX, so this file
imports none, and neither may its run load tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances: the kernel vs its torch twin on the card — bit-identical
(same op order, f32, no fused multiply-add on either side); the GPU path
vs the CPU path (which runs the twin) — integers exact, float pools with
the share of |Δ| > 1e-4 below 1e-3, room for a last-bit difference
between the CPU's and the card's libraries to move a voxel's pixel at a
rounding boundary."""

import dataclasses

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import cuda_tsdf
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


@pytest.mark.cuda
@pytest.mark.parametrize("vps", [8, 16])
def test_kernel_matches_twin(gpu, vps):
    spec = vx.VoxelGridSpec(voxel_size=0.1 if vps == 8 else 0.05,
                            voxels_per_side=vps, grid_dim=16,
                            max_blocks=256, truncation=0.3)
    depths, colors, traj = _frames(gpu)
    planar = colors.permute(0, 3, 1, 2).contiguous()
    k = torch.zeros((), dtype=torch.int32, device=gpu)
    lk, lt = _stacked(spec, gpu), _stacked(spec, gpu)
    for f in range(2):
        sk, mk = tsdf._alloc_pass(spec, CFG, INTR, lk, k, depths[f],
                                  traj[f])
        st, mt = tsdf._alloc_pass(spec, CFG, INTR, lt, k, depths[f],
                                  traj[f])
        assert torch.equal(sk, st) and torch.equal(mk, mt)
        args = (k, sk, mk, depths[f], planar[f],
                geo.inverse(traj[f]).contiguous())
        before = cuda_tsdf.LAUNCHES
        cuda_tsdf.update_blocks(spec, CFG, INTR, lk, *args)
        assert cuda_tsdf.LAUNCHES == before + 1
        cuda_tsdf.update_blocks_reference(spec, CFG, INTR, lt, *args)
        torch.cuda.synchronize()
        assert int((lt.weight > 0).sum()) > 1000
        for f_ in dataclasses.fields(lk):
            assert torch.equal(getattr(lk, f_.name),
                               getattr(lt, f_.name)), f_.name


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
    before = cuda_tsdf.LAUNCHES
    for name, val, exc in bad:
        with pytest.raises(exc):
            cuda_tsdf.update_blocks(spec, CFG, INTR, lay,
                                    **dict(good, **{name: val}))
    assert cuda_tsdf.LAUNCHES == before


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
        before = cuda_tsdf.LAUNCHES
        assert hm.step_batch(depths.to(dev), colors.to(dev),
                             traj.to(dev), ts) == 3
        launched = cuda_tsdf.LAUNCHES - before
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
