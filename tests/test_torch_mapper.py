"""coxgraph_tpu_torch.mapper.submap_mapper vs coxgraph_tpu's mapper, with
the CFG of tests/test_mapper.py (80×60, 8³ blocks, 0.3 s submaps).

Tolerances: integers exact (submap count, hist_count, constraint pools,
mesh_dirty, union counters, allocation); poses and stamps atol 1e-6;
voxel pools to the repo's standard for differing program structures:
the share of |Δ| > 1e-4 below 1e-3, and |Δ| ≤ 5e-3 everywhere except
pixel flips — XLA fuses the projection's multiply-add (the port does
not), so a voxel whose pixel coordinate sits on a rounding boundary can
sample the neighbouring pixel; those stay below a 1e-5 share. Observed
in the rollover test: one voxel flips, i.e. 1 of 4,194,304 sdf values,
1 weight and 3 of 12,582,912 colour values beyond 5e-3 (share 2.4e-7);
the other tests show no value beyond 1e-4."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import tsdf as jtsdf
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
JCFG = jsm.MapperConfig(
    spec=jvx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                           max_blocks=1024, truncation=0.3),
    integrator=jtsdf.TsdfIntegratorConfig(max_touched_blocks=512,
                                          use_pallas=False),
    intrinsics=jsyn.PinholeIntrinsics().scaled(0.125),
    max_submaps=8,
    max_history=64,
    submap_interval=0.3,
)
CFG = interop.config_from(JCFG)
POOL_FLOATS = ("collection.layers.sdf", "collection.layers.weight",
               "collection.layers.color")
APPROX = ("collection.T_odom_submap", "collection.hist_poses",
          "collection.start_time", "collection.end_time",
          "collection.hist_stamps", "constraints.T_meas",
          "constraints.sqrt_info", "heights.height", "heights.info")


def _frames(n, sweep=np.pi):
    scene = jsyn.default_scene()
    traj = jsyn.orbit_trajectory(n, scene.room_center, radius=2.5,
                                 sweep=sweep)
    fr = [jsyn.render_depth(scene, JCFG.intrinsics, traj[i])
          for i in range(n)]
    return (np.stack([np.asarray(f[0]) for f in fr]),
            np.stack([np.asarray(f[1]) for f in fr]), np.array(traj))


def _jax_numpy(state):
    return {k: np.asarray(v) for k, v in interop.flatten(state).items()}


def _assert_state_matches(jstate, pstate):
    want = _jax_numpy(jstate)
    got = interop.mapper_state_to_numpy(pstate)
    assert set(got) == set(want)
    for key, a in want.items():
        b = got[key]
        assert b.shape == a.shape and b.dtype == a.dtype, key
        if key in POOL_FLOATS:
            d = np.abs(b - a)
            assert (d > 1e-4).mean() < 1e-3, key
            assert (d > 5e-3).mean() < 1e-5, (key, int((d > 5e-3).sum()))
        elif key in APPROX:
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)


def test_step_batch_matches_jax_across_rollovers():
    depths, colors, traj = _frames(10)
    ts = np.arange(10) * 0.1          # rollovers at 0, 0.3, 0.6, 0.9
    jm = jsm.HostMapper(JCFG)
    pm = sm.HostMapper(CFG, device=CPU)
    for lo, hi in ((0, 4), (4, 10)):  # two windows: the clock carries
        sj = jm.step_batch(depths[lo:hi], colors[lo:hi], traj[lo:hi],
                           ts[lo:hi])
        sp = pm.step_batch(depths[lo:hi], colors[lo:hi], traj[lo:hi],
                           ts[lo:hi])
        assert sp == sj
        assert pm.n_submaps == jm.n_submaps
        assert pm.last_start == jm.last_start
    assert pm.n_submaps == 4
    _assert_state_matches(jm.state, pm.state)
    # host mirror (numpy poses in → mirror stays on) matches JAX's
    assert pm.mirror_enabled and jm.mirror_enabled
    assert len(pm.host_submaps) == len(jm.host_submaps) == 4
    for a, b in zip(pm.host_submaps, jm.host_submaps):
        assert a["start"] == b["start"] and a["end"] == b["end"]
        assert a["stamps"] == b["stamps"]
        np.testing.assert_allclose(np.stack(a["poses"]),
                                   np.stack(b["poses"]), atol=1e-6)
    np.testing.assert_allclose(np.stack(pm.host_T_odom_submap),
                               np.stack(jm.host_T_odom_submap), atol=1e-6)
    assert pm.union_saturation() == jm.union_saturation()


def test_integrate_batch_equals_sequential_integrate():
    depths, colors, traj = _frames(4, sweep=0.4)
    ts = torch.arange(4, dtype=torch.float32) * 0.05

    def fresh():
        s = sm.create_mapper(CFG, CPU)
        return sm.start_submap(CFG, s, torch.from_numpy(traj[0]), ts[0])

    seq = fresh()
    for i in range(4):
        out = sm.integrate(CFG, seq, torch.from_numpy(depths[i]),
                           torch.from_numpy(colors[i]),
                           torch.from_numpy(traj[i]), ts[i])
        assert out is seq                  # updated in place
    bat = sm.integrate_batch(CFG, fresh(), torch.from_numpy(depths),
                             torch.from_numpy(colors),
                             torch.from_numpy(traj), ts)
    a = interop.mapper_state_to_numpy(seq)
    b = interop.mapper_state_to_numpy(bat)
    for key in a:
        if key == "union_watermark":       # integrate_batch's counter
            assert b[key] > 0 and a[key] == 0
            continue
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_start_submap_saturation_matches_jax():
    jcfg = dataclasses.replace(JCFG, max_submaps=2, height_prior_stddev=0.1)
    cfg = interop.config_from(jcfg)
    js = jsm.create_mapper(jcfg)
    ps = sm.create_mapper(cfg, CPU)
    for k in range(4):
        T = np.array([1.0, 0, 0, 0, float(k), 0.0, 0.2 * k], np.float32)
        js = jsm.start_submap(jcfg, js, jnp.asarray(T),
                              jnp.asarray(float(k)))
        sm.start_submap(cfg, ps, torch.from_numpy(T),
                        torch.tensor(float(k)))
    assert int(ps.collection.num_submaps) == 2
    assert int(ps.constraints.count) == 1 and int(ps.heights.count) == 2
    _assert_state_matches(js, ps)


def test_step_batch_saturation_matches_jax():
    jcfg = dataclasses.replace(JCFG, max_submaps=2, submap_interval=0.1)
    cfg = interop.config_from(jcfg)
    depth = np.full((4, 60, 80), 2.0, np.float32)
    Ts = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (4, 1))
    ts = np.arange(4, dtype=np.float32) * 0.1
    jm = jsm.HostMapper(jcfg)
    pm = sm.HostMapper(cfg, device=CPU)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        n_started = pm.step_batch(depth, None, Ts, ts)
        msgs = [w for w in rec if "submap pool saturated" in str(w.message)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert n_started == jm.step_batch(depth, None, Ts, ts) == 2
    assert pm.dropped_submaps == jm.dropped_submaps == 2 == len(msgs)
    _assert_state_matches(jm.state, pm.state)


def test_window_boundary_rollovers_exact_in_float64():
    """The rollover clock stays float64: windows exactly one submap
    interval long roll over at their first frame, 96 s into a mission."""
    WINDOW, DT = 24, 0.1
    cfg = sm.MapperConfig(
        spec=sm.vx.VoxelGridSpec(voxel_size=0.2, voxels_per_side=8,
                                 grid_dim=16, max_blocks=64, truncation=0.6),
        integrator=sm.tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=32),
        intrinsics=sm.PinholeIntrinsics().scaled(0.025),   # 16x12
        max_submaps=64, max_history=32, submap_interval=WINDOW * DT)
    mapper = sm.HostMapper(cfg, device=CPU)
    depth = np.full((WINDOW, 12, 16), 2.0, np.float32)
    poses = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                    (WINDOW, 1))
    for w in range(40):
        ts = (np.arange(WINDOW) + w * WINDOW) * DT
        assert mapper.step_batch(depth, None, poses, ts) == 1, w
        assert mapper.last_start == float(ts[0]), w
    assert mapper.n_submaps == 40


def test_step_matches_step_batch():
    """Per-frame HostMapper.step ≡ step_batch across rollovers."""
    depths, colors, traj = _frames(8)
    ts = np.arange(8) * 0.1
    a = sm.HostMapper(CFG, device=CPU)
    starts = sum(a.step(depths[i], colors[i], traj[i], float(ts[i]))
                 for i in range(8))
    b = sm.HostMapper(CFG, device=CPU)
    assert b.step_batch(depths, colors, traj, ts) == starts == 3
    sa = interop.mapper_state_to_numpy(a.state)
    sb = interop.mapper_state_to_numpy(b.state)
    for key in sa:
        if key == "union_watermark":
            continue
        np.testing.assert_array_equal(sb[key], sa[key], err_msg=key)


def test_consume_mesh_dirty_pops_row():
    depths, colors, traj = _frames(2, sweep=0.2)
    pm = sm.HostMapper(CFG, device=CPU)
    pm.step_batch(depths, colors, traj, [0.0, 0.1])
    row, state = sm.consume_mesh_dirty(pm.state, 0)
    assert state is pm.state
    assert int(row.sum()) == int(pm.state.collection.layers.num_blocks[0])
    assert not bool(pm.state.mesh_dirty.any())


def test_toggle_mapping_drops_frames():
    pm = sm.HostMapper(CFG, device=CPU)
    pm.mapping_enabled = False
    depth = np.full((1, 60, 80), 2.0, np.float32)
    T = np.array([[1, 0, 0, 0, 0, 0, 0]], np.float32)
    assert pm.step_batch(depth, None, T, [0.0]) == 0
    assert pm.step(depth[0], None, T[0], 0.0) is False
    assert pm.n_submaps == 0 and int(pm.state.frame_count) == 0


def test_host_mapper_needs_state_or_device(monkeypatch):
    """With neither a state nor a device HostMapper goes to the card:
    without one it raises, and the CPU serves only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sm.HostMapper(CFG)
    asked = []
    monkeypatch.setattr(runtime, "require_cuda",
                        lambda: asked.append(1) or CPU)
    assert sm.HostMapper(CFG).device == CPU and asked == [1]
    assert sm.HostMapper(CFG, device=CPU).device == CPU and asked == [1]


def _poses_close(a, b, tol):
    a, b = torch.as_tensor(a).double(), torch.tensor(np.asarray(b)).double()
    rot = geo.so3_log(geo.rotation(geo.relative(a, b))).norm(dim=-1)
    assert float((a[..., 4:] - b[..., 4:]).norm(dim=-1).max()) <= tol
    assert float(rot.max()) <= tol


@pytest.mark.parametrize("variant", ["plain", "heights_huber"])
def test_loop_closure_finish_map_and_trajectory_match_jax(variant):
    """add_loop_closure, HostMapper.finish_map (optimize_local with the
    config's local solver, height priors on or off) and trajectory on a
    JAX mapper state carried across: constraint pools exact (T_meas
    1e-6), trajectory stamps exact and poses 1e-6 on identical states,
    optimized submap poses 1e-4 (m and rad)."""
    extra = {} if variant == "plain" else dict(
        height_prior_stddev=0.05,
        local_solver=jpg.SolverConfig(iterations=10, huber_delta=0.5))
    jcfg = dataclasses.replace(JCFG, **extra)
    cfg = interop.config_from(jcfg)
    depths, colors, traj = _frames(8)
    jm = jsm.HostMapper(jcfg)
    jm.step_batch(depths, colors, traj, np.arange(8) * 0.1)
    pm = sm.HostMapper(cfg, state=interop.mapper_state_from_numpy(
        _jax_numpy(jm.state), CPU))
    assert pm.n_submaps == jm.n_submaps == 3

    for jcol, pcol in ((jm.state.collection, pm.state.collection),):
        js, jp = jsm.trajectory(jcol)
        ps, pp = sm.trajectory(pcol)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-6,
                                   rtol=0)
        assert ps.shape == (8,)

    T = np.asarray(jm.state.collection.T_odom_submap)
    T_02 = jgeo.compose(jgeo.relative(T[0], T[2]), jgeo.se3_exp(
        jnp.array([0.02, -0.01, 0.03, 0.1, -0.05, 0.04])))
    jm.state = jsm.add_loop_closure(jm.state, 0, 2, T_02,
                                    5.0 * jnp.eye(6))
    sm.add_loop_closure(pm.state, 0, 2, torch.from_numpy(np.array(T_02)),
                        5.0 * torch.eye(6))
    _assert_state_matches(jm.state, pm.state)

    jm.finish_map()
    pm.finish_map()
    assert not pm.mapping_enabled and not jm.mapping_enabled
    _poses_close(pm.state.collection.T_odom_submap,
                 jm.state.collection.T_odom_submap, 1e-4)
    moved = np.abs(np.asarray(jm.state.collection.T_odom_submap)[:3]
                   - T[:3]).max()
    assert moved > 1e-3
    js, jp = jsm.trajectory(jm.state.collection)
    ps, pp = sm.trajectory(pm.state.collection)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    _poses_close(pp, jp, 1e-4)


def test_trajectory_of_an_empty_mapper():
    stamps, poses = sm.trajectory(sm.create_collection(CFG, CPU))
    assert stamps.shape == (0,) and poses.shape == (0, 7)
