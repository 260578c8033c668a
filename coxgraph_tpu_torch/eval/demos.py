"""The two-robot collaborative reconstruction demo — port of the body of
``examples/two_robot_demo.py`` (the CVG two-client experiment,
BASELINE.json config 4): two robots with separate drifting odometry
frames map overlapping halves of a scene; the loop detector finds
cross-robot correspondences; the fusion server aligns the client frames,
runs the two-phase global solve on a background thread while the robots
keep streaming, and builds one global mesh and per-client trajectories.

``TwoRobotDemo`` keeps the world between its two halves (``stream``,
``finish``) so a caller can inspect the server in between;
``two_robot_demo`` runs both and returns what the JAX demo prints.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends import loop_detector as ld
from ..frontends import synthetic as syn
from ..frontends.vio_interface import VIOInterface
from ..mapper import submap_mapper as sm
from ..ops import features as ft
from ..ops import registration as reg
from ..ops import tsdf as tsdf_ops
from ..server import fusion_server as fs
from ..server.client_interface import InProcessClient
from ..utils.tensorops import upload
from . import export, metrics

DT = 0.05            # s between frames
ATE_GATE = 0.13      # m: the demo's gate (~2× its measured operating point)
SURFACE_GATE = 4.0   # voxels, surface error p90


def demo_configs(frames: int, scale: float, reg_weight: float):
    """(MapperConfig, ServerConfig, LoopDetectorConfig, final-mesh spec)
    of the JAX demo: 5 cm voxels, 16³ blocks, 2,048 blocks × 8 submaps per
    client, a 48-submap server with async PGO, the detector at K = 384."""
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16, grid_dim=64,
                            max_blocks=2048, truncation=0.15)
    cfg = sm.MapperConfig(
        spec=spec,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=1024),
        intrinsics=syn.PinholeIntrinsics().scaled(scale),
        max_submaps=8, max_history=256,
        submap_interval=frames * DT / 6)
    server_cfg = fs.ServerConfig(
        spec=spec, max_submaps=48, refuse_interval=0.15,
        registration_weight=reg_weight, async_pgo=True,
        registration=reg.RegistrationConfig(max_points=1024, iterations=10))
    det_cfg = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=384),
        min_match_score=25, min_inliers=15,
        keyframe_stride=4 * DT, min_time_separation=1e9)
    mesh_spec = vx.VoxelGridSpec(
        voxel_size=spec.voxel_size, voxels_per_side=16, grid_dim=64,
        max_blocks=6144, truncation=spec.truncation)
    return cfg, server_cfg, det_cfg, mesh_spec


class TwoRobotDemo:
    """The demo's world on ``device`` (None: the card). Trajectories and
    odometry are made on the host from seeds 0 and 1 (torch's stream, not
    jax.random's); frames are rendered on the device as they stream."""

    def __init__(self, device=None, frames: int = 40, scale: float = 0.25,
                 reg_weight: float = 30.0, configs=None):
        """``configs``: ``demo_configs``' tuple to run instead of the
        demo's own (the tests' small pools)."""
        self.device = (runtime.require_cuda() if device is None
                       else torch.device(device))
        self.frames = frames
        self.cfg, self.server_cfg, det_cfg, self.mesh_spec = (
            configs or demo_configs(frames, scale, reg_weight))
        cpu = torch.device("cpu")
        scene_h = syn.default_scene(cpu)
        self.scene = syn.default_scene(self.device)
        trajs = [syn.orbit_trajectory(frames, scene_h.room_center,
                                      radius=2.4, sweep=1.2 * math.pi,
                                      start_angle=a)
                 for a in (0.0, math.pi)]
        # two robots, distinct odom frames (yaw + offset)
        self.X = [geo.identity_np(),
                  geo.from_xyzyaw(torch.tensor([0.8, -0.4, 0.0, 0.5])
                                  ).numpy()]
        odoms = []
        for r in range(2):
            g = torch.Generator().manual_seed(r)
            odoms.append(syn.noisy_odometry(g, trajs[r], rot_std=0.002,
                                            trans_std=0.005).numpy())
        self.trajs = [t.numpy() for t in trajs]
        self.odoms = odoms
        self.clients = [InProcessClient(r, self.cfg,
                                        sm.create_mapper(self.cfg,
                                                         self.device))
                        for r in range(2)]
        self.server = fs.CoxgraphServer(self.server_cfg, self.clients,
                                        self.device)
        self.vios = [VIOInterface(r, self.cfg, self.clients[r], self.server)
                     for r in range(2)]
        self.detector = ld.LoopDetector(self.cfg.intrinsics, det_cfg,
                                        self.device)
        self.accepted = []        # the MapFusionMsgs the server accepted

    def stream(self) -> dict:
        """Both robots' frames through VIOInterface, the detector's
        messages through publish_loop_closure, then wait out the last
        background solve → the streaming half's numbers."""
        n, server = self.frames, self.server
        fusion_dispatch = 0.0     # time the stream thread spent in fusions
        self._fence()
        t0 = time.perf_counter()
        for i in range(n):
            for r in range(2):
                depth, color = syn.render_depth(
                    self.scene, self.cfg.intrinsics,
                    upload(self.trajs[r][i], self.device))
                T_odom_cam = geo.compose_np(geo.inverse_np(self.X[r]),
                                            self.odoms[r][i])
                self.vios[r].update_pose(T_odom_cam, i * DT, depth, color)
                for mf in self.detector.add_keyframe(r, i * DT, color,
                                                     depth):
                    if self.vios[r].need_to_fuse(mf.from_client,
                                                 mf.to_client, mf.to_time):
                        tf0 = time.perf_counter()
                        ok = self.vios[r].publish_loop_closure(
                            mf.from_client, mf.from_time, mf.to_client,
                            mf.to_time, mf.T_from_to)
                        fusion_dispatch += time.perf_counter() - tf0
                        if ok:
                            self.accepted.append(mf)
        server.wait_for_optimize()
        self._fence()
        wall = time.perf_counter() - t0
        solve_walls = [f.get("solve_wall", 0.0) for f in server.fusion_log]
        solve = sum(solve_walls)
        # solve time that ran while frames streamed = total solve time
        # minus what fusions cost the stream thread
        overlap = max(0.0, solve - fusion_dispatch)
        err = geo.se3_log(geo.relative(
            torch.from_numpy(np.asarray(server.T_G_cli[1], np.float32)),
            torch.from_numpy(self.X[1]))).numpy()
        return {"frames": 2 * n, "stream_s": wall, "fps": 2 * n / wall,
                "fusions": len(self.accepted),
                "coalesced_solves": server.coalesced_solves,
                "solves": len(server.fusion_log),
                "server_submaps": len(server.submaps),
                "solve_s": solve, "solve_walls": solve_walls,
                "fusion_dispatch_s": fusion_dispatch,
                "overlap_s": overlap,
                "overlap_share": overlap / solve if solve > 0 else 0.0,
                "align_rot": float(np.linalg.norm(err[:3])),
                "align_trans": float(np.linalg.norm(err[3:])),
                "optimize_errors": list(server.optimize_errors)}

    def finish(self, skip_mesh: bool = False,
               out: Optional[str] = None) -> dict:
        """The final global mesh (or, with ``skip_mesh``, the final
        collect + optimize alone), the surface error against the analytic
        scene, each client's global-frame ATE and the bytes shipped. With
        ``out`` the mesh PLY and the TUM trajectories are written there."""
        server = self.server
        if out:
            os.makedirs(out, exist_ok=True)
        res = {}
        self._fence()
        t0 = time.perf_counter()
        if skip_mesh:
            server.collect_all_submaps()
            if len(server.submaps) >= 2:
                server.optimize()
            n_tris, sdf = None, None
        else:
            _, verts, _ = server.get_final_global_mesh(
                os.path.join(out, "global_mesh.ply") if out else None,
                mesh_spec=self.mesh_spec)
            n_tris = int(verts.shape[0])
            sdf = np.abs(syn.scene_sdf(self.scene, upload(
                np.ascontiguousarray(verts.reshape(-1, 3)), self.device)
            ).cpu().numpy())
        self._fence()
        res["final_mesh_s"] = time.perf_counter() - t0
        res["triangles"] = n_tris
        res["surf_p50"] = None if sdf is None else float(np.median(sdf))
        res["surf_p90"] = None if sdf is None else float(
            np.quantile(sdf, 0.9))
        ates = []
        gt_stamps = np.arange(self.frames) * DT
        for r in range(2):
            stamps, poses = server.pose_history(r)
            order = np.argsort(stamps)
            ates.append(metrics.ate_rmse(stamps[order], poses[order],
                                         gt_stamps, self.trajs[r],
                                         align=False))
            if out:
                export.write_tum_trajectory(
                    os.path.join(out, f"client{r}.tum"), stamps[order],
                    poses[order])
        res["ate"] = ates
        res["bytes_shipped"] = sum(c.bytes_sent for c in self.clients)
        res["server_submaps_final"] = len(server.submaps)
        voxel = self.cfg.spec.voxel_size
        res["ok"] = bool(
            max(ates) < ATE_GATE
            and (skip_mesh or (n_tris > 1000
                               and res["surf_p90"] < SURFACE_GATE * voxel)))
        return res

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def two_robot_demo(device=None, frames: int = 40, scale: float = 0.25,
                   reg_weight: float = 30.0, skip_mesh: bool = False,
                   out: Optional[str] = None) -> dict:
    """Run the demo on ``device`` (None: the card) → frames/s, fusions
    accepted, server submaps, solve wall, the share of the solve that
    overlapped streaming, the client-1 frame alignment error, triangles,
    surface error p50/p90 (m), ATE per client (m), bytes shipped, the
    final mesh's wall and ``ok`` (the demo's gates: ≥ 1 fusion, no solve
    error, max ATE < 0.13 m, > 1,000 triangles, surface p90 < 4 voxels)."""
    demo = TwoRobotDemo(device, frames, scale, reg_weight)
    res = demo.stream()
    res.update(demo.finish(skip_mesh, out))
    res["ok"] = bool(res["ok"] and res["fusions"] > 0
                     and not res["optimize_errors"])
    return res


# ---------------------------------------------------------------------------
# The small two-client world of the JAX package's server tests
# ---------------------------------------------------------------------------

SMALL_DT = 0.1
SMALL_FRAMES = 8


def small_world_configs():
    """(MapperConfig, ServerConfig) of tests/test_server.py: 10 cm voxels,
    8³ blocks, 1,024 blocks × 8 submaps, 80×60 frames, 0.2 s submaps; a
    32-submap server without async PGO."""
    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                            max_blocks=1024, truncation=0.3)
    cfg = sm.MapperConfig(
        spec=spec,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512),
        intrinsics=syn.PinholeIntrinsics().scaled(0.125),
        max_submaps=8, max_history=64, submap_interval=0.2)
    server_cfg = fs.ServerConfig(
        spec=spec, max_submaps=32, refuse_interval=0.0,
        registration=reg.RegistrationConfig(max_points=512, iterations=8))
    return cfg, server_cfg


def small_two_client_world(device, height: float = 0.0):
    """tests/test_server.py's world (build_two_clients) built by the port
    on ``device``: two robots orbiting complementary, overlapping halves
    of the scene, client 1's odom frame moved by a yaw and a translation,
    8 frames each through ``mapper_step`` → (trajs [(8, 7) numpy] × 2,
    X [(7,) numpy] × 2, clients).

    ``height`` raises the orbits above the room centre (0: the test's
    world), pitching every camera toward the centre. At 0 every camera is
    level, so a submap's registration samples land on the other submap's
    half-voxel lattice, where the trilinear cell and the 8-corner
    validity follow the last bit of the poses (ROADMAP queue 3)."""
    cfg, _ = small_world_configs()
    device = torch.device(device)
    scene = syn.default_scene(device)
    trajs = [syn.orbit_trajectory(SMALL_FRAMES, scene.room_center,
                                  radius=2.3, height=height,
                                  sweep=0.8 * math.pi, start_angle=a)
             for a in (0.0, 0.6 * math.pi)]
    X = [geo.identity_np(),
         geo.from_xyzyaw(torch.tensor([1.0, -0.5, 0.0, 0.6])).numpy()]
    clients = []
    for cid in range(2):
        state = sm.create_mapper(cfg, device)
        X_inv = upload(geo.inverse_np(X[cid]), device)
        for i in range(SMALL_FRAMES):
            d, c = syn.render_depth(scene, cfg.intrinsics, trajs[cid][i])
            sm.mapper_step(cfg, state, d, c,
                           geo.compose(X_inv, trajs[cid][i]), i * SMALL_DT)
        clients.append(InProcessClient(cid, cfg, state))
    return [t.cpu().numpy() for t in trajs], X, clients


def true_fusion(trajs, ta: int, tb: int) -> fs.MapFusionMsg:
    """The exact 0 → 1 loop closure between frames ``ta`` and ``tb`` of the
    small world (test_server.true_fusion_msg)."""
    return fs.MapFusionMsg(0, ta * SMALL_DT, 1, tb * SMALL_DT,
                           geo.relative_np(trajs[0][ta], trajs[1][tb]))
