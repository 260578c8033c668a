"""Driver entry points of the parallel tier — port of the JAX package's
``__graft_entry__``: ``entry`` (one frame's integration, the per-robot
hot path) and ``dryrun_multichip`` (the multi-robot dry run through
``parallel/``).

On one card, ``dryrun_multichip(n)`` runs ``n`` robots in this process
(a world-size-1 NCCL group of its own when none is set up); on the CPU, a
gloo group of ``w`` ranks holds ``n / w`` robots each (``spawn_dryrun``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends import synthetic as syn
from ..mapper import submap_mapper as sm
from ..ops import esdf as esdf_ops
from ..ops import tsdf as tsdf_ops
from ..parallel import esdf_sharded as es
from ..parallel import fleet as fl
from ..parallel import merge_sharded as msh
from ..parallel import multihost
from ..parallel.collectives import RobotMesh, gather_rows, psum
from ..solver import pose_graph as pg
from ..utils.tensorops import host

S = 3                      # submaps per robot
F = 3                      # frames per robot (one rollover each)


def entry(device=None):
    """→ (fn, example_args): one projective TSDF frame integration into a
    block-sparse submap layer (the per-robot hot path) at 160×120, IN
    PLACE, on ``device`` (None: the card)."""
    device = runtime.require_cuda() if device is None else device
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16, grid_dim=64,
                            max_blocks=2048, truncation=0.15)
    cfg = tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=1024)
    intr = syn.PinholeIntrinsics().scaled(0.25)

    def fn(layer, depth, color, T_sm_cam):
        return tsdf_ops.integrate_frame(spec, cfg, intr, layer, depth, color,
                                        T_sm_cam)

    layer = vx.create_tsdf_layer(spec, device)
    depth = torch.full((intr.height, intr.width), 2.0, device=device)
    color = torch.full((intr.height, intr.width, 3), 0.5, device=device)
    return fn, (layer, depth, color, geo.identity(device))


def dryrun_config() -> sm.MapperConfig:
    """The dry run's robots: 16³ blocks of 10 cm, 80×60 frames, three
    submaps each (every frame rolls over)."""
    return sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=16,
                              grid_dim=16, max_blocks=256, truncation=0.3),
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=128),
        intrinsics=syn.PinholeIntrinsics().scaled(0.125),
        max_submaps=S, max_history=8,
        submap_interval=0.1,   # < frame spacing ⇒ every frame rolls over
        max_constraints=16)


def dryrun_frames(cfg: sm.MapperConfig, R: int, device):
    """Each robot sweeps its own sector of the scene; the odometry drifts
    from the truth (seed 11) → (true_T, odom_T (F,R,7), depths (F,R,H,W),
    colors (F,R,H,W,3)) on ``device``."""
    scene = syn.default_scene(device)
    rng = np.random.default_rng(11)
    true_T, odom_T, depths, colors = [], [], [], []
    for r in range(R):
        traj = syn.orbit_trajectory(F, scene.room_center, radius=2.4,
                                    sweep=0.3 * math.pi,
                                    start_angle=2 * math.pi * r / R)
        drift = geo.identity(device)
        for f in range(F):
            d, c = syn.render_depth(scene, cfg.intrinsics, traj[f])
            depths.append(d)
            colors.append(c)
            true_T.append(traj[f])
            odom_T.append(geo.compose(drift, traj[f]))
            drift = geo.compose(drift, geo.se3_exp(torch.tensor(
                rng.normal(0, 0.01, 6), dtype=torch.float32, device=device)))

    def by_frame(xs):
        return torch.stack(xs).reshape((R, F) + xs[0].shape).transpose(0, 1)

    return by_frame(true_T), by_frame(odom_T), by_frame(depths), \
        by_frame(colors)


def closures(true_T: torch.Tensor, R: int) -> pg.RelPoseConstraints:
    """Intra-robot (submap 0 ↔ 2) and inter-robot (consecutive robots'
    submap 0) measurements from the true poses, global indices."""
    dev = true_T.device
    eye = 10.0 * torch.eye(6, device=dev)
    inter = pg.RelPoseConstraints.empty(2 * R + 4, dev)
    for r in range(R):
        inter = inter.add(r * S, r * S + 2,
                          geo.relative(true_T[0, r], true_T[2, r]), eye)
    for r in range(R - 1):
        inter = inter.add(r * S, (r + 1) * S,
                          geo.relative(true_T[0, r], true_T[0, r + 1]), eye)
    return inter


def sphere_layer(spec: vx.VoxelGridSpec, device) -> vx.TsdfLayer:
    """A 2 m sphere's TSDF over the 8³ blocks around the origin."""
    layer = vx.create_tsdf_layer(spec, device)
    r4 = np.arange(-4, 4)
    bx, by, bz = np.meshgrid(r4, r4, r4, indexing="ij")
    coords = torch.from_numpy(np.stack([bx, by, bz], -1).reshape(-1, 3)
                              .astype(np.int32)).to(device)
    layer = vx.allocate_blocks(spec, layer, coords)
    centers = vx.voxel_centers_of_block(spec, layer.block_coords)
    true = torch.linalg.norm(centers, dim=-1) - 2.0
    live = (torch.arange(spec.max_blocks, device=device)
            < layer.num_blocks)[:, None]
    sdf = torch.clamp(true, -spec.truncation, spec.truncation)
    return dataclasses.replace(
        layer, sdf=torch.where(live, sdf.reshape(spec.max_blocks, -1),
                               layer.sdf),
        weight=torch.where(live, 1.0, layer.weight))


def merge_poses(device):
    return [geo.identity(device),
            geo.from_xyzyaw(torch.tensor([0.2, 0.0, 0.0, 0.0], device=device)),
            geo.from_xyzyaw(torch.tensor([0.0, 0.2, 0.0, 0.1], device=device))]


def _run(n: int, mesh: RobotMesh) -> dict:
    device = mesh.device
    R = n
    cfg = dryrun_config()
    fleet = fl.shard_fleet(fl.create_fleet(cfg, R, device), mesh)
    true_T, odom_T, depths, colors = dryrun_frames(cfg, R, device)
    for f in range(F):
        fl.fleet_step(cfg, mesh, fleet, depths[f], colors[f], odom_T[f],
                      torch.full((R,), 0.12 * f, device=device))
    nsub = [int(st.collection.num_submaps) for st in fleet.states]
    assert nsub == [S] * len(nsub), nsub
    nblocks = int(psum(mesh, torch.stack([
        st.collection.layers.num_blocks.sum() for st in fleet.states]).sum()))
    assert nblocks >= 512, f"dryrun occupancy too small: {nblocks} blocks"

    fleet, poses = fl.fleet_optimize(cfg, mesh, fleet, closures(true_T, R),
                                     pg.SolverConfig(iterations=3))
    assert poses.shape == (R * S, 7) and bool(torch.isfinite(poses).all())

    # block-sharded ESDF with halo exchange at ≥ 512 live blocks: one slab
    # per robot, capacities fitted to the partition (the JAX package's
    # fixed 160-block slabs overflow below 8 slabs)
    spec = dataclasses.replace(cfg.spec, max_blocks=640)
    layer = sphere_layer(spec, device)
    assert int(layer.num_blocks) >= 512
    ecfg = es.fitted_config(spec, layer, R,
                            esdf_ops.EsdfConfig(max_distance=1.5))
    parts = es.partition_blocks(spec, layer, R, ecfg)
    d_esdf = es.esdf_sharded(spec, mesh, parts, ecfg)
    assert d_esdf.shape[0] == len(mesh.share(R))

    # sharded global merge of posed full-occupancy layers
    merged = msh.merge_layers_sharded(spec, mesh, [layer] * 3,
                                      merge_poses(device),
                                      max_touched=spec.max_blocks)
    assert int(merged.num_blocks) >= 512
    return {"nblocks": nblocks, "poses": host(poses),
            "dist": host(gather_rows(mesh, d_esdf, R)),
            "merged": {f.name: host(getattr(merged, f.name))
                       for f in dataclasses.fields(merged)}}


def dryrun_multichip(n: int, device=None,
                     mesh: Optional[RobotMesh] = None) -> dict:
    """An n-robot dry run at representative scale: 16³-voxel blocks,
    hundreds of live blocks a robot, three submaps a robot from rendered
    frames with drifting odometry, intra- and inter-robot closures from
    the true poses reconciled by the distributed LM, then the block-sharded
    ESDF (512 live blocks, halo exchange) and the sharded global merge.

    ``mesh`` None: over the default group when one is set up, else in a
    world-size-1 group of its own on ``device`` (None: the card) →
    {"nblocks", "poses" (n·3,7), "dist" (every slab), "merged"
    (the fused layer's fields)}, numpy."""
    if mesh is not None:
        out = _run(n, mesh)
    elif dist.is_initialized():
        out = _run(n, fl.make_robot_mesh(n, device))
    else:
        device = runtime.require_cuda() if device is None else device
        with multihost.single_process(device):
            out = _run(n, fl.make_robot_mesh(n, device))
    print(f"dryrun_multichip({n}): {out['nblocks']}-block fleet ({S} "
          f"submaps/robot) + drift-reconciling distributed PGO + sharded "
          f"ESDF (512 blocks) + sharded merge OK")
    return out


def _spawned_dryrun(n: int, device):
    """One rank of spawn_dryrun (torch on one thread on the CPU)."""
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    return dryrun_multichip(n, device)


def spawn_dryrun(n: int, world: int, device=None,
                 backend: Optional[str] = None) -> list:
    """dryrun_multichip(n) over ``world`` spawned ranks, ``device`` None:
    each its card (see multihost.spawn) → each rank's result."""
    return multihost.spawn(_spawned_dryrun, world, (n, device), device,
                           backend)
