"""TSDF integration and serving benchmarks — port of the TSDF half of
``coxgraph_tpu.eval.benchmarks`` — and the loop-detection operating point.

The integration measurement is the per-robot streaming hot path
(``mapper.integrate_batch``) at the reference operating point: 640×480
RGB-D, 5 cm voxels, 16³ blocks, 0.15 m truncation, 10 m max range, on a
30-frame orbit clip that the port renders itself on the given device.
``stage_benchmark`` times the serving stages over the same map: ESDF,
mesh extraction, layer merge and serving while streaming.

The loop-detection point is the endurance run's detector
(``detector_config``) on two robots' 640×480 clips (``two_robot_clip``).

The solve point (``solve_benchmark_problem``, ``solve_benchmark``) is the
server's two-phase optimize over a 64-submap odometry chain on a wavy
floor with a z-drift bias: ≥ 100 overlapping registration pairs.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

N_FRAMES = 30
SCALE = 1.0  # 640x480
KF_DT = 0.5  # s between a robot's keyframes in the two-robot clip


def _mapper_config():
    """The bench operating point (identical to the JAX package's)."""
    from ..core import voxel as vx
    from ..frontends import synthetic as syn
    from ..mapper import submap_mapper as sm
    from ..ops import tsdf as tsdf_ops

    return sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16,
                              grid_dim=64, max_blocks=2048,
                              truncation=0.15),
        # a frame of this clip touches 59–187 blocks (median 151 of the 512
        # lanes; chip_smoke.py phase 4 counts them); alloc_stride 8 still
        # lands ≥5 samples per block footprint at 640×480
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512,
                                                 alloc_stride=8),
        intrinsics=syn.PinholeIntrinsics().scaled(SCALE),
        max_submaps=4,
        max_history=1024,
        submap_interval=1e9,  # single submap: pure integration throughput
    )


def generate_frames(device, n_frames: int = N_FRAMES,
                    render: int | None = None):
    """Render the bench clip on ``device`` → (depths (N,H,W), colors
    (N,H,W,3), traj (N,7)), all f32. ``render``: only the clip's first
    ``render`` frames (N = ``render``; the orbit still spans
    ``n_frames``)."""
    from ..frontends import synthetic as syn

    cfg = _mapper_config()
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(n_frames, scene.room_center, radius=2.5)
    traj = traj[:render]
    ds, cs = [], []
    for i in range(traj.shape[0]):
        d, c = syn.render_depth(scene, cfg.intrinsics, traj[i])
        ds.append(d)
        cs.append(c)
    return torch.stack(ds), torch.stack(cs), traj


def tsdf_benchmark(depths, colors, traj, n_frames: int | None = None,
                   windows: int = 4) -> float:
    """Sustained streaming integration rate on the frames' device →
    frames/s. Warms one integrate_batch window, then times ``windows``
    back-to-back windows of a fresh map with ONE fence at the end
    (``torch.cuda.synchronize()`` and a readback of the weight checksum),
    so the fence is not charged to each window."""
    from ..mapper import submap_mapper as sm

    device = depths.device
    cfg = _mapper_config()
    n = n_frames or depths.shape[0]
    depths, colors, traj = depths[:n], colors[:n], traj[:n]
    ts = torch.arange(n, dtype=torch.float32, device=device) * 0.05

    def fence(s):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return float(s.collection.layers.weight.sum())

    def fresh():
        s = sm.create_mapper(cfg, device)
        return sm.start_submap(cfg, s, traj[0], ts[0])

    state = fresh()
    sm.integrate_batch(cfg, state, depths, colors, traj, ts)
    fence(state)

    state = fresh()
    fence(state)
    t0 = time.perf_counter()
    for _ in range(windows):
        sm.integrate_batch(cfg, state, depths, colors, traj, ts)
    fence(state)
    return n * windows / (time.perf_counter() - t0)


def _fence(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_benchmark(depths, colors, traj) -> dict:
    """Serving-stage times over the bench map on the frames' device, each
    timed call after a warm one and ending in ``torch.cuda.synchronize()``
    → {union_watermark, dropped_union_blocks (of the 30-frame integration
    run), esdf_ms, esdf_blocks (batch ESDF build), mesh_extract_ms,
    mesh_tris (full extraction with the quantized readback), merge_ms
    (the layer merged at the identity pose into an empty pool of twice
    its blocks, built outside the timed region), serve_while_streaming_fps,
    serve_live_mesh_tris (3 windows of HostMapper.step_batch → live_mesh
    → ESDF of the active submap, each window served before the next)}."""
    from ..core import geometry as geo
    from ..core import voxel as vx
    from ..mapper import submap_mapper as sm
    from ..ops import esdf as esdf_ops
    from ..ops import merge as merge_ops
    from ..ops import mesh as mesh_ops

    device = depths.device
    cfg = _mapper_config()
    n = depths.shape[0]
    ts = torch.arange(n, dtype=torch.float32, device=device) * 0.05
    s = sm.create_mapper(cfg, device)
    sm.start_submap(cfg, s, traj[0], ts[0])
    sm.integrate_batch(cfg, s, depths, colors, traj, ts)
    layer = sm.get_layer(s.collection.layers, 0)
    out = {"union_watermark": int(s.union_watermark),
           "dropped_union_blocks": int(s.dropped_union_blocks)}

    esdf_ops.esdf_from_tsdf(cfg.spec, layer)                  # warm
    _fence(device)
    t0 = time.perf_counter()
    esdf_ops.esdf_from_tsdf(cfg.spec, layer)
    _fence(device)
    out["esdf_ms"] = (time.perf_counter() - t0) * 1e3
    out["esdf_blocks"] = int(layer.num_blocks)

    mesh_ops.extract_mesh(cfg.spec, layer, min_weight=0.1)    # warm
    _fence(device)
    t0 = time.perf_counter()
    v, _ = mesh_ops.extract_mesh(cfg.spec, layer, min_weight=0.1)
    out["mesh_extract_ms"] = (time.perf_counter() - t0) * 1e3
    out["mesh_tris"] = int(v.shape[0])

    dst_spec = dataclasses.replace(cfg.spec,
                                   max_blocks=2 * cfg.spec.max_blocks)
    pose = geo.identity(device)
    dst_warm = vx.create_tsdf_layer(dst_spec, device)
    dst_timed = vx.create_tsdf_layer(dst_spec, device)
    merge_ops.merge_layer_into_sized(dst_spec, dst_warm, layer, pose,
                                     src_spec=cfg.spec)       # warm
    _fence(device)
    t0 = time.perf_counter()
    merge_ops.merge_layer_into_sized(dst_spec, dst_timed, layer, pose,
                                     src_spec=cfg.spec)
    _fence(device)
    out["merge_ms"] = (time.perf_counter() - t0) * 1e3
    del dst_warm, dst_timed

    mapper = sm.HostMapper(cfg, device=device)
    ts_np = np.arange(n, dtype=np.float32) * 0.05

    def serve():
        mapper.step_batch(depths, colors, traj, ts_np)
        v, _ = mapper.live_mesh()
        esdf_ops.esdf_from_tsdf(
            cfg.spec, sm.get_layer(mapper.state.collection.layers, 0))
        _fence(device)
        return v.shape[0]

    serve()                                                   # warm
    windows = 3
    t0 = time.perf_counter()
    for _ in range(windows):
        tris = serve()
    out["serve_while_streaming_fps"] = n * windows / (
        time.perf_counter() - t0)
    out["serve_live_mesh_tris"] = int(tris)
    return out


def detector_config():
    """The loop detector of the JAX package's endurance run
    (tools/endurance_run.py:239-252): K = 384, 512 slots, 8-frame
    sub-batches, 64 slots per match step."""
    from ..frontends import loop_detector as ld
    from ..ops import features as ft

    return ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=384),
        min_match_score=25, min_inliers=15, keyframe_stride=0.4,
        min_time_separation=6.0, sqrt_info=100.0, max_keyframes=512,
        batch_size=8, match_chunk=64)


def two_robot_clip(device, n_frames: int = 10):
    """Two robots orbiting the default scene (tests/test_loop_detector.py's
    orbits): robot 0 sweeps π/2 from angle 0, robot 1 π/2 from -0.15 rad.
    Rendered on ``device`` at the bench resolution → (intrinsics, [traj
    (n, 7)] × 2, [[(depth (H, W), color (H, W, 3))] × n] × 2)."""
    from ..frontends import synthetic as syn

    scene = syn.default_scene(device)
    intr = syn.PinholeIntrinsics().scaled(SCALE)
    trajs = [syn.orbit_trajectory(n_frames, scene.room_center, radius=2.5,
                                  sweep=math.pi / 2, start_angle=a)
             for a in (0.0, -0.15)]
    frames = [[syn.render_depth(scene, intr, T) for T in traj]
              for traj in trajs]
    return intr, trajs, frames


# ---------------------------------------------------------------------------
# Solve-side benchmark: the server's two-phase optimize
# ---------------------------------------------------------------------------

SOLVE_N = 64
SOLVE_SPACING = 0.8  # m between consecutive submap origins along x


def _wavy_floor_sdf(p):
    """Egg-crate floor whose wavelength (~1.6 m) matches the submap patch
    size, so every patch sees full surface curvature."""
    return p[..., 2] - 0.15 * torch.sin(4.0 * p[..., 0]) \
        - 0.1 * torch.cos(3.0 * p[..., 1])


def solve_benchmark_problem(n: int = SOLVE_N, device=None):
    """n-submap odometry chain over the wavy floor with a drift bias (the
    JAX package's problem, the chain drawn from
    ``np.random.default_rng(7)`` the same way) → (init_poses (n,7),
    constraints, layers, spec, reg_cfg, solver_cfg, fixed (n,)), the
    tensors on ``device`` (default: the card). The chain's measurements
    are composed on the CPU, as the reference composes them."""
    from .. import runtime
    from ..core import geometry as geo
    from ..core import voxel as vx
    from ..ops import registration as reg
    from ..solver import pose_graph as pg

    device = runtime.require_cuda() if device is None else device
    cpu = torch.device("cpu")
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                            max_blocks=64, truncation=0.3)
    reg_cfg = reg.RegistrationConfig(max_points=256, min_weight=0.5)
    rng = np.random.default_rng(7)
    true_poses = geo.from_xyzyaw(torch.tensor(
        [[k * SOLVE_SPACING, 0.0, 0.0, 0.0] for k in range(n)],
        dtype=torch.float32)).numpy()

    xs, ys, zs = np.arange(-1, 1), np.arange(-2, 2), np.arange(-1, 1)
    coords = torch.from_numpy(np.stack(np.meshgrid(
        xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3).astype(
        np.int32)).to(device)
    base = vx.allocate_blocks(spec, vx.create_tsdf_layer(spec, device),
                              coords)
    centers = vx.voxel_centers_of_block(spec, base.block_coords).reshape(
        -1, 3)
    live = (torch.arange(spec.max_blocks, device=device)
            < base.num_blocks)[:, None]

    def make_layer(T_world_submap):
        pw = geo.transform_points(T_world_submap, centers).reshape(
            spec.max_blocks, -1, 3)
        sdf = torch.clamp(_wavy_floor_sdf(pw), -spec.truncation,
                          spec.truncation)
        ramp = torch.clamp(1.0 - torch.abs(sdf) / spec.truncation,
                           min=0.0)
        weight = torch.where(live & (torch.abs(sdf) < spec.truncation),
                             ramp, 0.0)
        return dataclasses.replace(
            base, sdf=sdf, weight=weight, color=base.color.clone(),
            block_index=base.block_index.clone(),
            block_coords=base.block_coords.clone(),
            num_blocks=base.num_blocks.clone())

    true_dev = torch.from_numpy(true_poses).to(device)
    layers = [make_layer(true_dev[k]) for k in range(n)]
    cons = pg.RelPoseConstraints.empty(2 * n, cpu)
    info = 20.0 * torch.eye(6)
    init = [true_poses[0]]
    for k in range(n - 1):
        T_rel_true = geo.relative_np(true_poses[k], true_poses[k + 1])
        noise = rng.normal(0, 0.004, 6)
        noise[5] += 0.008  # z drift bias (tangent = rx ry rz x y z)
        T_rel_meas = geo.compose(
            torch.from_numpy(T_rel_true),
            geo.se3_exp(torch.from_numpy(noise.astype(np.float32))))
        cons = cons.add(k, k + 1, T_rel_meas, info)
        init.append(geo.compose_np(init[-1], T_rel_meas.numpy()))
    cons = pg.RelPoseConstraints(**{
        f.name: getattr(cons, f.name).to(device)
        for f in dataclasses.fields(cons)})
    fixed = torch.arange(n, device=device) == 0
    return (torch.from_numpy(np.stack(init).astype(np.float32)).to(device),
            cons, layers, spec, reg_cfg, pg.SolverConfig(iterations=10),
            fixed)


def solve_benchmark(reg_iterations: int = 6, repeats: int = 3,
                    device=None, problem=None) -> dict:
    """Warm-then-timed two-phase optimize on ``device`` (default: the
    card) → {"solve_s" (the first timed call's wall), "solve_best_s"
    (best of ``repeats``), "pairs", "submaps"}. Each call ends in
    ``torch.cuda.synchronize()`` and a readback of the poses. The
    per-submap surface-point caches and the stacked field are held
    across calls, as the server holds them across optimizes.
    ``problem``: a ``solve_benchmark_problem`` result to reuse."""
    from ..server import global_opt

    init, cons, layers, spec, reg_cfg, solver_cfg, fixed = (
        problem if problem is not None
        else solve_benchmark_problem(device=device))
    caches = [None] * len(layers)
    stack_cache: dict = {}

    def solve():
        return global_opt.optimize_two_phase(
            init, cons, spec, layers, reg_cfg=reg_cfg,
            solver_cfg=solver_cfg, registration_weight=30.0,
            reg_iterations=reg_iterations, fixed=fixed,
            reg_caches=caches, stack_cache=stack_cache)

    def fenced():
        poses, info = solve()
        _fence(poses.device)
        float(poses.sum())
        return info

    fenced()                                    # warm caches
    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        info = fenced()
        walls.append(time.perf_counter() - t0)
    return {"solve_s": walls[0], "solve_best_s": min(walls),
            "pairs": int(info["n_registration_pairs"]),
            "submaps": len(layers)}
