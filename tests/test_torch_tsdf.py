"""coxgraph_tpu_torch.ops.tsdf / ops.cuda_tsdf vs coxgraph_tpu.ops.tsdf at
80×60 with 8³ blocks, on frames rendered by the JAX package.

Tolerances:
* allocation integers (block_index, block_coords, num_blocks, the
  window's updated bitmap and union size) — exact;
* float pools vs the JAX XLA path (use_pallas=False) — the repo's
  standard for differing program structures (tests/test_mapper.py:239):
  atol 5e-3, and the share of |Δ| > 1e-4 below 1e-3 (observed: no value
  above 1e-4 in any test here, max |Δ| 3.2e-6);
* vs the JAX Pallas window (interpret mode) — the repo's Pallas-vs-XLA
  gate: q95 |Δsdf| < 5e-3 over voxels both observe, weight-mask IoU > 0.9;
* the CUDA kernel vs its torch twin: tests/test_torch_cuda.py (the card's
  machine has no JAX, so the GPU tests live in a file that does not
  import it)."""

import dataclasses
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.ops import pallas_tsdf
from coxgraph_tpu.ops import tsdf as jtsdf
from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.ops import cuda_alloc, cuda_tsdf
from coxgraph_tpu_torch.ops import tsdf
from coxgraph_tpu_torch.utils import interop, tensorops

CPU = torch.device("cpu")
JINTR = jsyn.PinholeIntrinsics().scaled(0.125)  # 80x60
JSPEC = jvx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                          max_blocks=256, truncation=0.3)
JCFG = jtsdf.TsdfIntegratorConfig(max_touched_blocks=64, use_pallas=False)
INTR, SPEC, CFG = (interop.config_from(x) for x in (JINTR, JSPEC, JCFG))
INTS = ("block_index", "block_coords", "num_blocks")
FLOATS = ("sdf", "weight", "color")


def _frames(n, sweep=0.3 * np.pi):
    scene = jsyn.default_scene()
    traj = jsyn.orbit_trajectory(n, scene.room_center, radius=2.5,
                                 sweep=sweep)
    fr = [jsyn.render_depth(scene, JINTR, traj[i]) for i in range(n)]
    return (np.stack([np.asarray(f[0]) for f in fr]),
            np.stack([np.asarray(f[1]) for f in fr]), np.asarray(traj))


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_pools_match(jl, pl):
    for name in INTS:
        np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                      np.asarray(getattr(jl, name)), name)
    for name in FLOATS:
        a = np.asarray(getattr(jl, name))
        b = getattr(pl, name).numpy()
        d = np.abs(b - a)
        assert (d > 1e-4).mean() < 1e-3, name
        assert d.max() <= 5e-3, (name, float(d.max()))


def test_alloc_candidates_exact():
    depths, _, traj = _frames(3)
    n_diff = n_all = 0
    for f in range(3):
        gj, vj = jtsdf._alloc_candidates_soa(JSPEC, JCFG, JINTR,
                                             jnp.asarray(depths[f]),
                                             jnp.asarray(traj[f]))
        gp, vp = cuda_alloc.alloc_candidates_reference(
            SPEC, CFG, INTR, _t(depths[f]), _t(traj[f]))
        assert gp.dtype == torch.int32 and vp.dtype == torch.bool
        np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
        n_diff += int((gp.numpy() != np.asarray(gj))[vp.numpy()].sum())
        n_all += int(vp.sum())
    # XLA fuses the projection's multiply-adds (the port does not), which
    # may flip a candidate across a floor boundary: allow ≤ 0.1%
    # (observed: 0 of 2469 valid candidates over these 3 frames)
    assert n_diff <= 1e-3 * n_all, (n_diff, n_all)


@pytest.mark.parametrize("st", [1, 2, 3, 8])
def test_decimate_matches_jax(st):
    img = np.random.default_rng(st).normal(size=(2, 13, 22)).astype(
        np.float32)
    np.testing.assert_array_equal(tensorops.decimate(_t(img), st).numpy(),
                                  np.asarray(jtsdf.decimate(
                                      jnp.asarray(img), st)))


def test_color_layout():
    assert tsdf.color_layout(torch.zeros(3, 60, 80), 60, 80) == "planar"
    assert tsdf.color_layout(torch.zeros(60, 80, 3), 60, 80) == \
        "interleaved"
    with pytest.raises(ValueError):
        tsdf.color_layout(torch.zeros(60, 3, 80), 60, 80)


@pytest.mark.parametrize("vps,with_color", [
    (8, True), (8, False),
    # the GPU tests' other block sizes (tests/test_torch_cuda.py): 4³ and
    # 16³ rows take the kernel's 2-voxels-per-thread path, 5³ its
    # per-voxel path; 10 cm voxels, 5 cm at 16³
    (4, True), (5, True), (16, True)],
    ids=["color", "depth_only", "v4", "v5", "v16"])
def test_integrate_frame_matches_jax(vps, with_color):
    depths, colors, traj = _frames(1)
    c = colors[0] if with_color else None
    jspec = dataclasses.replace(JSPEC, voxels_per_side=vps,
                                voxel_size=0.05 if vps == 16 else 0.1)
    spec = interop.config_from(jspec)
    jl = jtsdf.integrate_frame(jspec, JCFG, JINTR,
                               jvx.create_tsdf_layer(jspec),
                               jnp.asarray(depths[0]),
                               None if c is None else jnp.asarray(c),
                               jnp.asarray(traj[0]))
    pl = vx.create_tsdf_layer(spec, CPU)
    out = tsdf.integrate_frame(spec, CFG, INTR, pl, _t(depths[0]),
                               None if c is None else _t(c), _t(traj[0]))
    assert out is pl                        # updated in place
    assert int(pl.num_blocks) > 10
    _assert_pools_match(jl, pl)


def test_integrate_window_matches_jax():
    depths, colors, traj = _frames(3)
    js = jax.tree.map(lambda x: x[None], jvx.create_tsdf_layer(JSPEC))
    js, (nu_j, nd_j, up_j) = jtsdf.integrate_window_stacked_impl(
        JSPEC, JCFG, JINTR, js, jnp.asarray(0), jnp.asarray(depths),
        jnp.asarray(colors), jnp.asarray(traj), return_stats=True)
    pl = vx.create_tsdf_layer(SPEC, CPU)
    ps = vx.TsdfLayer(**{f.name: getattr(pl, f.name)[None]
                         for f in dataclasses.fields(pl)})
    # planar colours: the layout the mapper hands the window
    up_p = tsdf.integrate_window_stacked_impl(
        SPEC, CFG, INTR, ps, torch.zeros((), dtype=torch.int32),
        _t(depths), _t(colors).permute(0, 3, 1, 2), _t(traj))
    _assert_pools_match(js, ps)
    # the port's bitmap carries JAX's union size; JAX drops no update on
    # these inputs (the port has no working set to drop from)
    assert int(up_p.sum()) == int(nu_j) > 0
    assert int(nd_j) == 0
    np.testing.assert_array_equal(up_p.numpy(), np.asarray(up_j))


def test_window_matches_jax_pallas_interpret(monkeypatch):
    """The port against the TPU kernel's own path (Pallas window in
    interpret mode), held to the repo's Pallas-vs-XLA gate."""
    real = pallas_tsdf.tsdf_update_blocks_ws

    def interpret(*a, **kw):
        kw["interpret"] = True
        return real(*a, **kw)

    monkeypatch.setattr(pallas_tsdf, "tsdf_update_blocks_ws", interpret)
    depths, colors, traj = _frames(3)
    cfg_p = dataclasses.replace(JCFG, use_pallas=True,
                                window_union_blocks=128)
    js = jax.tree.map(lambda x: x[None], jvx.create_tsdf_layer(JSPEC))
    js = jtsdf.integrate_window_stacked_impl(
        JSPEC, cfg_p, JINTR, js, jnp.asarray(0), jnp.asarray(depths),
        jnp.asarray(colors), jnp.asarray(traj))
    pl = vx.create_tsdf_layer(SPEC, CPU)
    ps = vx.TsdfLayer(**{f.name: getattr(pl, f.name)[None]
                         for f in dataclasses.fields(pl)})
    tsdf.integrate_window_stacked_impl(
        SPEC, CFG, INTR, ps, torch.zeros((), dtype=torch.int32),
        _t(depths), _t(colors), _t(traj))
    v3 = JSPEC.voxels_per_side ** 3
    wj = np.asarray(js.weight).reshape(-1, v3)
    wp = pl.weight.numpy().reshape(-1, v3)
    both = (wj > 0) & (wp > 0)
    assert both.sum() > 1000
    d = np.abs(np.asarray(js.sdf).reshape(-1, v3) - pl.sdf.numpy().reshape(
        -1, v3))[both]
    assert np.quantile(d, 0.95) < 5e-3
    iou = both.sum() / max(((wj > 0) | (wp > 0)).sum(), 1)
    assert iou > 0.9, iou


def test_update_blocks_refuses_other_devices():
    """No fallback: a pool on a device that is neither CPU nor CUDA
    raises instead of being routed to the twin."""
    depths, colors, traj = _frames(1)
    cpu = vx.create_tsdf_layer(SPEC, CPU)
    layers = vx.TsdfLayer(**{f.name: getattr(cpu, f.name)[None].to("meta")
                             for f in dataclasses.fields(cpu)})
    before = runtime.launches("k1")
    with pytest.raises(ValueError):
        cuda_tsdf.update_blocks(
            SPEC, CFG, INTR, layers, torch.zeros((), dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32),
            torch.zeros(64, dtype=torch.bool), _t(depths[0]),
            _t(colors[0]).permute(2, 0, 1).contiguous(), _t(traj[0]))
    assert runtime.launches("k1") == before


def test_variant_edits_apply_to_the_kernel_source():
    """tools/time_k1_variants.py times K1 against edited copies of its
    source: each of its edits must still match the source exactly once
    and change it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = runpy.run_path(os.path.join(repo, "tools", "time_k1_variants.py"),
                          run_name="not_main")
    with open(os.path.join(repo, "coxgraph_tpu_torch", "csrc",
                           "tsdf_update.cu")) as f:
        src = f.read()
    assert tool["VARIANTS"]
    for name, (_, edits) in tool["VARIANTS"].items():
        assert tool["_edited"](src, edits) != src, name
