"""TSDF integration benchmark — port of the TSDF half of
``coxgraph_tpu.eval.benchmarks`` — and the loop-detection operating point.

The integration measurement is the per-robot streaming hot path
(``mapper.integrate_batch``) at the reference operating point: 640×480
RGB-D, 5 cm voxels, 16³ blocks, 0.15 m truncation, 10 m max range, on a
30-frame orbit clip that the port renders itself on the given device.

The loop-detection point is the endurance run's detector
(``detector_config``) on two robots' 640×480 clips (``two_robot_clip``).
"""

from __future__ import annotations

import math
import time

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
