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


def generate_frames(device, n_frames: int = N_FRAMES):
    """Render the bench clip on ``device`` → (depths (N,H,W), colors
    (N,H,W,3), traj (N,7)), all f32."""
    from ..frontends import synthetic as syn

    cfg = _mapper_config()
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(n_frames, scene.room_center, radius=2.5)
    ds, cs = [], []
    for i in range(n_frames):
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
