"""The drivers of the port — runtime.Timers, eval.demos.single_robot_demo
and eval.endurance — against the JAX package's examples/single_robot_demo.py
and tools/endurance_run.py, on the CPU at small sizes.

Tolerances: Timers' report text and JSON exact on equal totals. The
single-robot demo (10 cm voxels, 8³ blocks, 80×60, 16 frames, JAX's
noisy odometry fed to both) against the JAX demo's flow on the same
config: trajectories before and after optimize_local within 1e-4 (m and
quaternion components), ATE raw and optimized within 1e-4 m, the merged
layer's block count equal. The demo's orbit is level, so its first
submap merges on the voxel lattice, where jitted JAX and the port part
on a few tenths of a percent of the merged voxels (ROADMAP queue 3;
0.35% here, by a validity flip or a rounding of the trilinear cell):
from there the triangle count is held within 1% (0.41% observed) and the
surface p90 within 2 mm (1.17 mm observed), and the port's extractor and
metric on JAX's own merged layer to its triangle count exactly (the two
meshes sit within one quantization step, ROADMAP parity notes) and its
p90 within 1e-5 m. The
endurance odometry against the script's formula through the JAX package
over two 96-frame laps: the ground truth within 5e-6 (the orbit's f32
trigonometry at 2.4 m; 2.3e-6 observed) and the odometry within 5e-5,
the roundings of 191 composed se3_exp steps, whose θ ≈ 1e-3 rad sits in
the reference's small-angle cancellation range (ROADMAP queue 3; 1.3e-5
observed). The
one-lap mission (a 24-frame lap of 12-frame windows at 80×60, small
pools and detector) runs its four threads to their joins and writes
every key of the script's JSON.
"""

import ast
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.eval import metrics as jmetrics
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import mesh as jmesh
from coxgraph_tpu.ops import tsdf as jtsdf
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu.utils import runtime as jruntime
from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.eval import demos
from coxgraph_tpu_torch.eval import endurance as en
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.ops import features as ft
from coxgraph_tpu_torch.ops import mesh as mesh_ops
from coxgraph_tpu_torch.utils import interop
from test_torch_mesh import one_thread  # noqa: F401

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_FRAMES = 16
DEMO_JCFG = jsm.MapperConfig(
    spec=jvx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                           max_blocks=1024, truncation=0.3),
    integrator=jtsdf.TsdfIntegratorConfig(max_touched_blocks=512,
                                          use_pallas=False),
    intrinsics=jsyn.PinholeIntrinsics().scaled(0.125),
    max_submaps=8, max_history=64,
    submap_interval=DEMO_FRAMES * demos.SINGLE_DT / 8)


# ---------------------------------------------------------------------------
# runtime.Timers
# ---------------------------------------------------------------------------


def test_timers_report_and_json_match_jax():
    jt, pt = jruntime.Timers(), runtime.Timers()
    for t in (jt, pt):
        for name in ("render", "mapper_step", "render"):
            with t.scope(name):
                pass
    with pt.scope("mesh", sync=torch.zeros(3)):    # a CPU tensor: no fence
        pass
    with jt.scope("mesh", sync=jnp.zeros(3)):
        pass
    assert dict(pt.count) == dict(jt.count) == {"render": 2,
                                                "mapper_step": 1, "mesh": 1}
    for t in (jt, pt):
        t.total.update({"render": 0.25, "mapper_step": 1.5, "mesh": 0.001})
    assert pt.report() == jt.report()
    assert pt.as_json() == jt.as_json()
    assert json.loads(pt.as_json())["render"] == {"n": 2, "total_s": 0.25}


# ---------------------------------------------------------------------------
# The single-robot demo
# ---------------------------------------------------------------------------


def _jax_single_robot(odom):
    """examples/single_robot_demo.py:55-116 through coxgraph_tpu on
    DEMO_JCFG with ``odom`` → the numbers the port's demo returns."""
    cfg, dt, frames = DEMO_JCFG, demos.SINGLE_DT, DEMO_FRAMES
    scene = jsyn.default_scene()
    traj_np = np.asarray(jsyn.orbit_trajectory(frames, scene.room_center,
                                               radius=2.5))
    mapper = jsm.HostMapper(cfg)
    for i in range(frames):
        depth, color = jsyn.render_depth(scene, cfg.intrinsics,
                                         jnp.asarray(traj_np[i]))
        mapper.step(depth, color, jnp.asarray(odom[i]), i * dt)
    state, ns = mapper.state, mapper.n_submaps
    gt_stamps = np.arange(frames) * dt
    stamps, poses_raw = (np.asarray(x) for x in
                         jsm.trajectory(state.collection))
    ate_raw = jmetrics.ate_rmse(stamps, poses_raw, gt_stamps, traj_np,
                                align=False)
    start = np.asarray(state.collection.start_time)
    frame_of = [int(round(float(start[k]) / dt)) for k in range(ns)]
    T_true = traj_np[frame_of]
    state = jsm.add_loop_closure(
        state, 0, ns - 1,
        jnp.asarray(jgeo.relative_np(T_true[0], T_true[ns - 1])),
        50.0 * jnp.eye(6))
    state = jsm.optimize_local(cfg, state, jpg.SolverConfig(iterations=20))
    _, poses_opt = (np.asarray(x) for x in jsm.trajectory(state.collection))
    ate_opt = jmetrics.ate_rmse(stamps, poses_opt, gt_stamps, traj_np,
                                align=False)
    merged = jsm.merged_layer(cfg, state.collection)
    verts, _ = jmesh.extract_mesh(cfg.spec, merged, min_weight=0.1)
    sdf = np.abs(np.asarray(jsyn.scene_sdf(scene, jnp.asarray(
        verts.reshape(-1, 3)))))
    return {"merged": {k: np.asarray(v) for k, v in
                       interop.flatten(merged).items()},
            "submaps": ns, "stamps": stamps, "poses_raw": poses_raw,
            "poses_opt": poses_opt, "ate_raw": ate_raw, "ate_opt": ate_opt,
            "merged_blocks": int(merged.num_blocks),
            "triangles": int(verts.shape[0]),
            "surf_p90": float(np.quantile(sdf, 0.9))}


def test_single_robot_demo_matches_jax(tmp_path):
    scene = jsyn.default_scene()
    traj = jsyn.orbit_trajectory(DEMO_FRAMES, scene.room_center, radius=2.5)
    odom = np.asarray(jsyn.noisy_odometry(jax.random.PRNGKey(0), traj,
                                          rot_std=0.004, trans_std=0.01))
    want = _jax_single_robot(odom)
    got = demos.single_robot_demo(CPU, frames=DEMO_FRAMES, out=str(tmp_path),
                                  odom=odom,
                                  cfg=interop.config_from(DEMO_JCFG))
    assert got["submaps"] == want["submaps"] == 8
    np.testing.assert_allclose(got["stamps"], want["stamps"], atol=1e-6)
    for key in ("poses_raw", "poses_opt"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0,
                                   err_msg=key)
    for key in ("ate_raw", "ate_opt"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    # the closure and the solve do what the demo is for
    assert got["ate_opt"] < got["ate_raw"]
    assert got["merged_blocks"] == want["merged_blocks"]
    assert abs(got["triangles"] - want["triangles"]) \
        <= 1e-2 * want["triangles"]
    assert abs(got["surf_p90"] - want["surf_p90"]) <= 2e-3
    # the port's extractor and metric on JAX's merged layer
    verts, _ = mesh_ops.extract_mesh(
        interop.config_from(DEMO_JCFG.spec),
        interop.layer_from_numpy(want["merged"], CPU), min_weight=0.1)
    assert verts.shape[0] == want["triangles"]
    sdf = syn.scene_sdf(syn.default_scene(CPU), torch.from_numpy(
        np.ascontiguousarray(verts.reshape(-1, 3)))).abs().numpy()
    assert abs(float(np.quantile(sdf, 0.9)) - want["surf_p90"]) <= 1e-5
    assert got["ok"] == (want["ate_opt"] < max(2.5 * want["ate_raw"], 0.08)
                         and want["triangles"] > 1000)
    assert got["timers"]["mapper_step"]["n"] == DEMO_FRAMES
    for name in ("global_mesh.ply", "trajectory.tum"):
        assert os.path.getsize(tmp_path / name) > 0


# ---------------------------------------------------------------------------
# The endurance mission
# ---------------------------------------------------------------------------


def _script_odometry(n_frames: int):
    """tools/endurance_run.py:81-83 and 184-202, through coxgraph_tpu."""
    scene = jsyn.default_scene()
    trajs = [np.asarray(jsyn.orbit_trajectory(
        en.N_LAP, scene.room_center, radius=2.4, sweep=2 * jnp.pi,
        start_angle=a0), np.float32) for a0 in (0.0, np.pi)]
    rng = np.random.default_rng(3)
    gt_all, odom_all = [], []
    X_np = [np.asarray(jgeo.identity()),
            np.asarray(jgeo.from_xyzyaw(jnp.array([0.8, -0.4, 0.0, 0.5])))]
    for r in range(2):
        gt = [trajs[r][i % en.N_LAP] for i in range(n_frames)]
        od = [gt[0]]
        for k in range(1, n_frames):
            T_rel = jgeo.relative_np(gt[k - 1], gt[k])
            noise = rng.normal(0, 0.0008, 6).astype(np.float32)
            noise[2] += 0.0008
            noise[3] += 0.0010
            T_rel = jgeo.compose_np(T_rel, np.asarray(jnp.asarray(
                jgeo.se3_exp(jnp.asarray(noise)))))
            od.append(jgeo.compose_np(od[-1], T_rel))
        gt_all.append(np.stack(gt))
        odom_all.append(np.stack([
            jgeo.compose_np(jgeo.inverse_np(X_np[r]), p) for p in od]))
    return gt_all, odom_all


def test_endurance_odometry_matches_the_script():
    n = 2 * en.N_LAP
    want_gt, want_od = _script_odometry(n)
    got_gt, got_od = en.endurance_odometry(en.lap_trajectories(), n)
    for r in range(2):
        np.testing.assert_allclose(got_gt[r], want_gt[r], atol=5e-6, rtol=0)
        np.testing.assert_allclose(got_od[r], want_od[r], atol=5e-5, rtol=0)
    # the drift the mission is about: robot 0 ends a few cm off
    assert np.linalg.norm(got_od[0][-1, 4:] - got_gt[0][-1, 4:]) > 0.01


def small_configs():
    """The mission's configurations cut to the CPU: 10 cm voxels, 8³
    blocks, 8 submaps a robot, a 32-submap server, the detector at K = 64
    with 32 slots; height priors, non-blocking async PGO and the rest as
    the mission has them."""
    import dataclasses

    cfg, server_cfg, det_cfg, _ = en.endurance_configs(0.125, 12)
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                            max_blocks=1024, truncation=0.3)
    cfg = dataclasses.replace(cfg, spec=spec, max_submaps=8, max_history=64)
    server_cfg = dataclasses.replace(
        server_cfg, spec=spec, max_submaps=32,
        registration=dataclasses.replace(server_cfg.registration,
                                         max_points=256, max_reg_blocks=256))
    det_cfg = dataclasses.replace(
        det_cfg, features=ft.FeatureConfig(max_keypoints=64),
        max_keyframes=32, match_chunk=16)
    return cfg, server_cfg, det_cfg, dataclasses.replace(spec,
                                                         max_blocks=2048)


def _script_keys():
    """The keys of the script's JSON, its stage walls and its wire stage
    (tools/endurance_run.py's ``art``, ``stage`` and ``bw_art`` dicts)."""
    with open(os.path.join(REPO, "tools", "endurance_run.py")) as f:
        tree = ast.parse(f.read())
    keys = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name)):
            keys[node.targets[0].id] = {k.value for k in node.value.keys}
    return keys["art"], keys["stage"], keys["bw_art"]


@pytest.fixture(scope="module")
def mission():
    """One lap of 24 frames a robot in 12-frame windows at 80×60 → the
    JSON and the mission's mappers' counts."""
    torch.set_num_threads(1)
    m = en.EnduranceMission(CPU, laps=1, scale=0.125, n_lap=24, window=12,
                            configs=small_configs())
    try:
        art = m.run(log=None)
    finally:
        m.close()
    return art


def test_one_lap_mission_runs_and_writes_the_script_keys(mission):
    art_keys, stage_keys, bw_keys = _script_keys()
    assert art_keys <= set(mission)
    assert set(mission["stage_wall_s"]) == stage_keys | {
        "live_mesh_lock_wait"}
    assert set(mission["wire_bandwidth"]) == bw_keys
    assert mission["device"] == "cpu" and mission["backend"] == "cpu"
    json.loads(json.dumps(mission))
    assert mission["threads_joined"] and mission["gates"]["threads_joined"]
    assert mission["optimize_errors"] == []
    # the mapper ran once a window, every frame integrated
    assert mission["mapper_windows"] == [2, 2]
    assert mission["integrated_frames"] == [24, 24]
    assert mission["frames"] == 48
    assert mission["keyframes"] == 12            # every 4th frame, 2 robots
    assert mission["live_mesh_updates"] == 1
    assert mission["final_mesh_tris"] > 1000
    assert mission["surface_err_p90_m"] < 4 * 0.1


def test_surface_gate_can_fail(mission):
    """The script's gate never bounds the surface error; the port's fails
    at 4 voxels."""
    voxel = 0.1
    assert en.mission_gates(mission, voxel)["surface"]
    for p90 in (4 * voxel, 1.0):
        gates = en.mission_gates(dict(mission, surface_err_p90_m=p90), voxel)
        assert not gates["surface"]


@pytest.fixture(scope="module")
def streamed():
    """A mission whose first window has streamed, no thread started."""
    torch.set_num_threads(1)
    m = en.EnduranceMission(CPU, laps=1, scale=0.125, n_lap=12, window=12,
                            configs=small_configs())
    m.stream_window(0, 0)
    yield m
    m.close()


def _wait(pred, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while not pred():
        assert time.perf_counter() < deadline, "timed out"
        time.sleep(0.01)


def _serving_thread(m):
    t = threading.Thread(target=m.serving_loop, daemon=True)
    t.start()
    return t


def _stop(m, t):
    m.serve_jobs.put(None)
    t.join(60.0)
    assert not t.is_alive()


def test_serving_error_is_recorded_and_the_next_request_served(
        streamed, mission):
    """The script's serving loop ends for good on its first exception;
    the port's records it, serves the next request, and the gate fails."""
    m = streamed
    real = m.mappers[0].live_mesh_async
    calls = []

    def flaky(**kw):
        calls.append(kw)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(**kw)

    m.mappers[0].live_mesh_async = flaky
    updates = m.serve_counts["updates"]
    t = _serving_thread(m)
    try:
        m.serve_jobs.put(True)
        _wait(lambda: m.errors)
        m.serve_jobs.put(True)
        _wait(lambda: m.serve_counts["updates"] > updates)
    finally:
        _stop(m, t)
        m.mappers[0].live_mesh_async = real
    assert m.errors == ["serving: RuntimeError: injected"]
    assert len(calls) == 2 and m.serve_counts["updates"] == updates + 1
    gates = en.mission_gates(dict(mission, optimize_errors=list(m.errors)),
                             0.1)
    assert not gates["no_error"]
    m.errors.clear()


def test_live_mesh_time_starts_when_the_lock_is_held(streamed):
    """With robot 0's lock held for 0.5 s, the wait lands in
    live_mesh_lock_wait and live_mesh counts only what follows it."""
    m = streamed
    hold = 0.5
    wait0 = m.stage["live_mesh_lock_wait"]
    held0 = m.stage["live_mesh"]
    updates = m.serve_counts["updates"]
    t = _serving_thread(m)
    try:
        with m.clients[0].lock:
            m.serve_jobs.put(True)
            time.sleep(hold)
            t_release = time.perf_counter()
        _wait(lambda: m.serve_counts["updates"] > updates)
        after = time.perf_counter() - t_release
    finally:
        _stop(m, t)
    waited = m.stage["live_mesh_lock_wait"] - wait0
    held = m.stage["live_mesh"] - held0
    assert waited >= hold - 0.05
    assert 0 < held <= after
    assert not m.errors
