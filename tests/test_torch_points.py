"""coxgraph_tpu_torch.ops.points and the mapper's point-cloud path against
coxgraph_tpu: tests/test_points.py's frame (a 160×120 render backprojected
to a cloud, 5 cm voxels, 8³ blocks, 1,024 blocks) through both packages.

The reference's bundling marks a bundle valid from its points' validity
permuted TWICE (``coxgraph_tpu/ops/points.py:116``: ``seg_sum`` permutes
its argument, and ``ok_s`` is already permuted), so with any invalid point
in a cloud it drops real bundles and keeps empty ones. The port computes
the validity of each bundle's own points;
``test_reference_bundle_validity_is_permuted_twice`` shows the fault, and
the parity tests hold the port to the reference with that one line
corrected (``fixed_reference``), never to the fault.

Tolerances: bundles, the allocated block set (block_index, block_coords,
num_blocks) and the slots are identical. A few voxels part where a band
sample sits on a voxel boundary and XLA's fused multiply-adds place it
in the neighbour (ROADMAP queue 3's parity notes): that moves one
bundle's weight, and shifts the weighted means of both voxels. So every
voxel has a bound, at least 2.3× the largest difference measured on the
CPU, and most have a tight one. One cloud: every observed voxel's
weight within 0.05 (measured at most 0.0203, beside weights up to 0.40),
at most 1e-4 of them beyond 1e-5 (measured 5.8e-5); sdf within 1e-5
(4.3e-6) and colour within 1e-4 (1.8e-5) wherever both packages observed
a voxel. After the mapper's eight clouds: weights within 0.5 (0.20,
beside weights up to 314), at most 1e-3 beyond 1e-5 (4.0e-4); where
both observed, sdf within 0.05 (0.018) and colour within 0.015
(0.0053), and within 1e-5 and 1e-4 where the weights agree. With the
drop-off ramp and distance weights off the weights are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_points as tp
from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import points as jpts
from coxgraph_tpu.ops import tsdf as jtsdf
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import points as pts
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
SPEC = interop.config_from(tp.SPEC)
_FRAME = {}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame():
    """tests/test_points.py's frame → (T, points, colors, valid) numpy."""
    if not _FRAME:
        _, T, depth, color = tp._frame()
        p, c, v = tp._cloud_from_depth(depth, color)
        _FRAME.update(T=np.asarray(T), p=np.asarray(p), c=np.asarray(c),
                      v=np.asarray(v))
    return _FRAME["T"], _FRAME["p"], _FRAME["c"], _FRAME["v"]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


_JAX_BUNDLE = jpts._bundle_points


def _valid_bundles(*args, **kw):
    """The reference's bundling with its validity corrected: a bundle is
    valid iff one of its points is, and every valid point carries a
    positive weight, so iff its summed weight is positive."""
    out = _JAX_BUNDLE(*args, **kw)
    return (*out[:-1], out[-2] > 0)


@pytest.fixture
def fixed_reference(monkeypatch):
    """The JAX integrator (and the mapper's step over it) with the bundle
    validity corrected, through fresh jits so no cached trace of the
    faulty version is reused."""
    monkeypatch.setattr(jpts, "_bundle_points", _valid_bundles)
    monkeypatch.setattr(jpts, "integrate_points", jax.jit(
        jpts.integrate_points_impl, static_argnums=(0, 1)))
    monkeypatch.setattr(jsm, "integrate_points", jax.jit(
        jsm.integrate_points_impl, static_argnums=0, donate_argnums=1))


def assert_layers_match(got, want, apart=1e-4, w_tol=0.05, sdf_tol=1e-5,
                        col_tol=1e-4):
    """``got`` (port numpy dict) ≡ ``want`` (JAX layer): the block set
    exact; every observed voxel's weight within ``w_tol``, and at most
    ``apart`` of them beyond 1e-5; sdf within ``sdf_tol`` and colour
    within ``col_tol`` wherever both observed the voxel, and within 1e-5
    and 1e-4 wherever the weights agree too."""
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want,
                                                                    name)))
    jw, pw = np.asarray(want.weight), got["weight"]
    dw = np.abs(jw - pw)
    obs = (jw > 0) | (pw > 0)
    assert dw[obs].max() <= w_tol, dw[obs].max()
    assert (dw[obs] > 1e-5).mean() <= apart, (dw[obs] > 1e-5).mean()
    both = (jw > 0) & (pw > 0)
    v3 = jw.shape[-1]
    jc = np.moveaxis(np.asarray(want.color).reshape(jw.shape[:-1] + (3, v3)),
                     -2, -1)
    pc = np.moveaxis(got["color"].reshape(jw.shape[:-1] + (3, v3)), -2, -1)
    jsdf = np.asarray(want.sdf)
    for mask, s_tol, c_tol in ((both, sdf_tol, col_tol),
                               (both & (dw <= 1e-5), 1e-5, 1e-4)):
        np.testing.assert_allclose(got["sdf"][mask], jsdf[mask], atol=s_tol,
                                   rtol=0)
        np.testing.assert_allclose(pc[mask], jc[mask], atol=c_tol, rtol=0)


def _bundle_inputs():
    T, p, c, v = frame()
    n = p.shape[0]
    w = np.random.RandomState(0).uniform(0.2, 1.0, n).astype(np.float32)
    v = v & (np.random.RandomState(1).rand(n) > 0.1)
    return [p[:, 0], p[:, 1], p[:, 2], c[:, 0], c[:, 1], c[:, 2], w, v]


def test_bundles_match_jax():
    args = _bundle_inputs()
    want = _valid_bundles(tp.SPEC, *map(jnp.asarray, args))
    got = pts._bundle_points(SPEC, *(t(x) for x in args))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    assert int(got[-1].sum()) > 1000
    for g, j in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=0)


def test_reference_bundle_validity_is_permuted_twice():
    """With invalid points in the cloud, the reference marks bundles
    valid from a twice-permuted mask: some bundles with points are
    dropped, some with none kept. The port's mask is each bundle's own."""
    args = _bundle_inputs()
    want = _JAX_BUNDLE(tp.SPEC, *map(jnp.asarray, args))
    got = pts._bundle_points(SPEC, *(t(x) for x in args))
    has_points = np.asarray(want[-2]) > 0
    np.testing.assert_array_equal(got[-1].numpy(), has_points)
    ref = np.asarray(want[-1])
    assert (has_points & ~ref).any() and (ref & ~has_points).any()


CASES = {"merged": {}, "simple": {"merge_points": False},
         "carving": {"carve_samples": 8},
         "flat_weights": {"use_distance_weight": False,
                          "use_dropoff": False}}


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_points_matches_jax(case, fixed_reference):
    T, p, c, v = frame()
    jcfg = jpts.PointIntegratorConfig(max_touched_blocks=512, **CASES[case])
    want = jpts.integrate_points(tp.SPEC, jcfg, jvx.create_tsdf_layer(tp.SPEC),
                                 jnp.asarray(p), jnp.asarray(c),
                                 jnp.asarray(v), jnp.asarray(T))
    layer = vx.create_tsdf_layer(SPEC, CPU)
    out = pts.integrate_points(SPEC, interop.config_from(jcfg), layer, t(p),
                               t(c), t(v), t(T))
    assert out is layer                       # in place
    got = interop.layer_to_numpy(layer)
    assert int(got["num_blocks"]) > 10
    assert_layers_match(got, want)
    if case == "flat_weights":
        np.testing.assert_array_equal(got["weight"], np.asarray(want.weight))


def test_stacked_isolation_and_touched_slots_match_jax(fixed_reference):
    """Into submap 1 of a two-submap stack: submap 0 stays empty, submap 1
    ≡ JAX's, and the touched-slot bitmap ≡ JAX's."""
    T, p, c, v = frame()
    jcfg = jpts.PointIntegratorConfig(max_touched_blocks=256)
    jstack = jax.tree.map(lambda x: jnp.stack([x, x]),
                          jvx.create_tsdf_layer(tp.SPEC))
    want, wtouched = jpts.integrate_points_stacked_impl(
        tp.SPEC, jcfg, jstack, jnp.asarray(1, jnp.int32), jnp.asarray(p),
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(T), return_stats=True)
    single = vx.create_tsdf_layer(SPEC, CPU)
    stack = vx.TsdfLayer(**{f.name: torch.stack([getattr(single, f.name)] * 2)
                            for f in dataclasses.fields(single)})
    _, touched = pts.integrate_points_stacked_impl(
        SPEC, interop.config_from(jcfg), stack,
        torch.tensor(1, dtype=torch.int32), t(p), t(c), t(v), t(T),
        return_stats=True)
    np.testing.assert_array_equal(touched.numpy(), np.asarray(wtouched))
    assert float(stack.weight[0].sum()) == 0.0
    assert int(stack.num_blocks[0]) == 0 and int(touched.sum()) > 0
    got = interop.layer_to_numpy(
        vx.TsdfLayer(**{f.name: getattr(stack, f.name)[1]
                        for f in dataclasses.fields(stack)}))
    assert_layers_match(got, jax.tree.map(lambda x: x[1], want))


@pytest.mark.parametrize("case", ["duplicates", "mask_and_range"])
def test_small_clouds_match_jax(case):
    """Two coincident points bundle into one ray of summed weight; a
    masked point and one out of range integrate nothing."""
    if case == "duplicates":
        p = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
        v = np.ones(2, bool)
        kw = dict(use_distance_weight=False, use_dropoff=False)
    else:
        p = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 50.0]], np.float32)
        v = np.array([False, True])
        kw = {}
    jcfg = jpts.PointIntegratorConfig(max_touched_blocks=64, **kw)
    T = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    want = jpts.integrate_points(tp.SPEC, jcfg, jvx.create_tsdf_layer(tp.SPEC),
                                 jnp.asarray(p), None, jnp.asarray(v),
                                 jnp.asarray(T))
    layer = pts.integrate_points(SPEC, interop.config_from(jcfg),
                                 vx.create_tsdf_layer(SPEC, CPU), t(p), None,
                                 t(v), t(T))
    got = interop.layer_to_numpy(layer)
    for name, a in interop.flatten(want).items():
        np.testing.assert_array_equal(got[name], np.asarray(a), err_msg=name)
    if case == "mask_and_range":
        assert float(layer.weight.sum()) == 0.0
    else:
        assert float(layer.weight.sum()) > 0.0


def _mapper_configs():
    jcfg = jsm.MapperConfig(
        spec=tp.SPEC,
        integrator=jtsdf.TsdfIntegratorConfig(max_touched_blocks=256),
        intrinsics=tp.INTR, max_submaps=4, max_history=16,
        submap_interval=0.4)
    return jcfg, interop.config_from(jcfg)


def test_step_points_matches_jax(fixed_reference):
    """HostMapper.step_points over test_points.py's 8-frame orbit: the
    same rollovers, histories, bookkeeping and mesh-dirty bits, layers at
    the module's tolerances, in both packages."""
    from coxgraph_tpu.frontends import synthetic as jsyn

    jcfg, cfg = _mapper_configs()
    scene = jsyn.default_scene()
    traj = np.asarray(jsyn.orbit_trajectory(8, scene.room_center,
                                            radius=2.0))
    jm = jsm.HostMapper(jcfg)
    pm = sm.HostMapper(cfg, device=CPU)
    for i in range(8):
        depth, color = jsyn.render_depth(scene, tp.INTR, traj[i])
        p, c, v = (np.asarray(x) for x in tp._cloud_from_depth(depth, color))
        a = jm.step_points(jnp.asarray(p), jnp.asarray(c), jnp.asarray(v),
                           jnp.asarray(traj[i]), 0.2 * i)
        b = pm.step_points(p, c, v, traj[i], 0.2 * i)
        assert a == b
    want = {k: np.asarray(x) for k, x in interop.flatten(jm.state).items()}
    got = interop.mapper_state_to_numpy(pm.state)
    assert int(got["collection.num_submaps"]) >= 2
    for key, a in want.items():
        if key.startswith("collection.layers."):
            continue
        np.testing.assert_allclose(got[key], a, atol=1e-6, rtol=0,
                                   err_msg=key)
    for k in range(int(got["collection.num_submaps"])):
        assert_layers_match(
            interop.layer_to_numpy(sm.get_layer(pm.state.collection.layers,
                                                k)),
            jsm._get_layer(jm.state.collection.layers, k), apart=1e-3,
            w_tol=0.5, sdf_tol=0.05, col_tol=0.015)
    assert pm.host_submaps and len(pm.host_submaps) == pm.n_submaps


def test_mapper_config_derives_the_point_config():
    jcfg, cfg = _mapper_configs()
    assert dataclasses.asdict(sm._point_cfg(cfg)) == \
        dataclasses.asdict(jsm._point_cfg(jcfg))
    own = pts.PointIntegratorConfig(band_samples=5)
    assert sm._point_cfg(dataclasses.replace(cfg,
                                             point_integrator=own)) is own
