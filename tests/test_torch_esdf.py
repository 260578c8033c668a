"""coxgraph_tpu_torch.ops.esdf vs coxgraph_tpu.ops.esdf on the 4³-block
sphere of tests/test_esdf.py and on a TSDF layer the JAX mapper
integrated (tests/test_mesh_incremental.py's 8³-block mapper, 80×60).

Tolerances: ``dist`` and ``observed`` bit-identical (torch.equal) for 6-
and 26-connectivity — every sweep is a select, min, max or add of the
same f32 values; face-neighbour slots, traversable masks and points
exact; ``sample_esdf`` within 1e-5 (XLA fuses the trilinear weights'
multiply-adds; observed max |Δ| 6e-8) with ``valid`` exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import esdf as jesdf
from coxgraph_tpu_torch.ops import esdf as pesdf
from coxgraph_tpu_torch.utils import interop
from test_esdf import SPEC as JSPEC, sphere_tsdf
from test_mesh_incremental import _mapper_cfg
from test_torch_mesh import one_thread  # noqa: F401

SPEC = interop.config_from(JSPEC)
CPU = torch.device("cpu")


def _layer_pair(jl):
    arr = {f.name: np.asarray(getattr(jl, f.name))
           for f in dataclasses.fields(jl)}
    return jl, interop.layer_from_numpy(arr, CPU)


def _sphere():
    return _layer_pair(sphere_tsdf([0.0, 0.0, 0.0], 0.35)[0])


def _integrated():
    """Submap 0 of the JAX mapper after 3 frames of the orbit clip."""
    cfg = _mapper_cfg()
    scene = jsyn.default_scene()
    traj = np.asarray(jsyn.orbit_trajectory(3, scene.room_center,
                                            radius=2.5, sweep=0.2 * np.pi))
    fr = [jsyn.render_depth(scene, cfg.intrinsics, traj[i])
          for i in range(3)]
    hm = jsm.HostMapper(cfg)
    hm.step_batch(np.stack([np.asarray(f[0]) for f in fr]),
                  np.stack([np.asarray(f[1]) for f in fr]), traj,
                  np.arange(3) * 0.1)
    jl = jsm.get_layer(hm.state.collection.layers, jnp.asarray(0))
    return interop.config_from(cfg.spec), cfg.spec, _layer_pair(jl)


def _assert_esdf_equal(ep, ej):
    want = {f.name: torch.from_numpy(np.array(getattr(ej, f.name)))
            for f in dataclasses.fields(ej)}
    for f in dataclasses.fields(ep):
        got = getattr(ep, f.name)
        assert got.dtype == want[f.name].dtype, f.name
        assert torch.equal(got, want[f.name]), f.name


@pytest.mark.parametrize("full,md", [(False, 1.0), (True, 0.55)])
def test_esdf_on_sphere_is_bit_identical(full, md):
    jl, pl = _sphere()
    jcfg = jesdf.EsdfConfig(max_distance=md, full_connectivity=full)
    ej = jesdf.esdf_from_tsdf(JSPEC, jl, jcfg)
    ep = pesdf.esdf_from_tsdf(SPEC, pl, interop.config_from(jcfg))
    _assert_esdf_equal(ep, ej)
    d = ep.dist.numpy()
    assert (d[ep.observed.numpy()] > JSPEC.truncation).any()


@pytest.mark.parametrize("full", [False, True])
def test_esdf_on_integrated_layer_is_bit_identical(full):
    spec, jspec, (jl, pl) = _integrated()
    jcfg = jesdf.EsdfConfig(max_distance=0.8, full_connectivity=full)
    ej = jesdf.esdf_from_tsdf(jspec, jl, jcfg)
    ep = pesdf.esdf_from_tsdf(spec, pl, interop.config_from(jcfg))
    _assert_esdf_equal(ep, ej)
    assert int(ep.observed.sum()) > 1000


def test_face_neighbor_indices_exact():
    jl, pl = _sphere()
    j = jesdf.face_neighbor_indices(JSPEC, jl.block_coords,
                                    jl.block_index.reshape(-1))
    p = pesdf.face_neighbor_indices(SPEC, pl.block_coords,
                                    pl.block_index.reshape(-1))
    assert set(j) == set(p)
    for k in j:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


def test_sample_esdf_and_traversable_points_match_jax():
    jl, pl = _sphere()
    cfg = jesdf.EsdfConfig(max_distance=1.0)
    ej = jesdf.esdf_from_tsdf(JSPEC, jl, cfg)
    arrays = {f.name: np.asarray(getattr(ej, f.name))
              for f in dataclasses.fields(ej)}
    ep = interop.esdf_layer_from_numpy(arrays, CPU)
    back = interop.esdf_layer_to_numpy(ep)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)
    p = np.random.default_rng(0).uniform(-1.2, 1.2, (2000, 3)).astype(
        np.float32)
    dj, okj = jesdf.sample_esdf(JSPEC, ej, jnp.asarray(p))
    dp, okp = pesdf.sample_esdf(SPEC, ep, torch.from_numpy(p))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), atol=1e-5,
                               rtol=0)
    assert int(okp.sum()) > 500
    for r in (0.1, 0.3):
        pj, mj = jesdf.traversable_points(JSPEC, ej, r)
        pp, mp = pesdf.traversable_points(SPEC, ep, r)
        np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
        assert int(mp.sum()) > 0
