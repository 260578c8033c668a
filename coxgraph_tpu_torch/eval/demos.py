"""The demos of the JAX package's ``examples/``, as functions that return
what the JAX scripts print.

``single_robot_demo`` is ``examples/single_robot_demo.py``: one robot's
synthetic clip through ``HostMapper.step`` with drifting odometry, a
ground-truth loop closure, local PGO, the merged map's mesh, the PLY and
TUM exports and the raw and optimized ATE.

The two-robot collaborative reconstruction demo — port of the body of
``examples/two_robot_demo.py`` (the CVG two-client experiment,
BASELINE.json config 4): two robots with separate drifting odometry
frames map overlapping halves of a scene; the loop detector finds
cross-robot correspondences; the fusion server aligns the client frames,
runs the two-phase global solve on a background thread while the robots
keep streaming, and builds one global mesh and per-client trajectories.

``TwoRobotDemo`` keeps the world between its two halves (``stream``,
``finish``) so a caller can inspect the server in between;
``two_robot_demo`` runs both and returns what the JAX demo prints.

``distributed_demo`` runs the same two robots the way the reference is
deployed (the flow of ``examples/experiment_driver.py``): each robot in
its own OS process on the card, serving its submaps over the native bus
to a fusion server in this process. ``pointcloud_demo`` is
``examples/pointcloud_demo.py``: unordered clouds through
``HostMapper.step_points``.

The real-sequence flows are the JAX package's replay tests:
``tum_pipeline`` is ``tests/test_tum_replay.py``'s full-pipeline check on
``tum_tiny``, ``drift_correction`` its drift-correction test on
``tum_loop`` and ``tests/test_real_replay.py``'s on ``tum_real`` (drifted
odometry, the loop detector on the decoded frames, every closure routed
through the server's intra-client branch to the local solve), at the
operating points of ``tum_loop_config`` and ``tum_real_config``.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import socket
import struct
import tempfile
import threading
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


def true_fusion(trajs, ta: int, tb: int,
                dt: float = SMALL_DT) -> fs.MapFusionMsg:
    """The exact 0 → 1 loop closure between frames ``ta`` and ``tb`` of two
    robots' ground-truth trajectories, ``dt`` s apart (the small world's by
    default, test_server.true_fusion_msg)."""
    return fs.MapFusionMsg(0, ta * dt, 1, tb * dt,
                           geo.relative_np(trajs[0][ta], trajs[1][tb]))


# ---------------------------------------------------------------------------
# The distributed deployment: robots in their own processes over the bus
# ---------------------------------------------------------------------------

ALIGN_GATE = 0.35    # |se3_log| of the client-frame error (the JAX drivers')


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fence(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _robot_main(port: int, client_id: int, frames: int, device_name: str,
                cfg: sm.MapperConfig) -> None:
    """One robot process (spawned): its ``two_robot_experiment`` clip
    rendered and integrated on ``device_name`` ("cuda": the card, which
    must exist), its submaps served through a ClientService, mapping
    gated by the toggle_mapping and finish_map services. A control
    service ``client<id>/demo`` answers b"rep" (its numbers), b"own" + k
    (submap k's live rows, read here), b"mesh" (from then on, one
    finished submap's MeshWithHistory a loop pass on its submap_mesh
    topic, so its services keep answering) and b"stop"."""
    from ..comm import bus as cbus
    from ..comm import wire
    from ..frontends import replay
    from ..mapper.map_server import MapServer
    from ..ops import cuda_tsdf

    device = (runtime.require_cuda() if device_name == "cuda"
              else torch.device(device_name))
    if device.type == "cpu":
        torch.set_num_threads(1)
    replays, _, _ = replay.two_robot_experiment(
        n_frames=frames, intr=cfg.intrinsics, dt=DT, device=device)
    clip = iter(replays[client_id])
    robot = InProcessClient(client_id, cfg, sm.create_mapper(cfg, device))
    mapper = sm.HostMapper(cfg, robot.state)
    robot.mapper = mapper
    robot.toggle_mapping(False)          # mapping waits for the toggle
    svc = cbus.ClientService(port, robot, cfg.spec)
    ctl = cbus.BusClient(port)
    ctl.advertise(f"client{client_id}/demo")
    cuda_tsdf.LAUNCHES = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    done, t_first, t_last = 0, None, None
    meshes, send_meshes, ms = [], False, MapServer(cfg)

    def answer(payload: bytes) -> bytes:
        if payload[:3] == b"own":
            (k,) = struct.unpack("<i", payload[3:])
            with robot.lock:
                coords, sdf, w, _ = wire.live_rows(
                    sm.get_layer(robot.state.collection.layers, k))
            return pickle.dumps((coords, sdf, w), protocol=4)
        return pickle.dumps({
            "frames": done, "k1_launches": cuda_tsdf.LAUNCHES,
            "fps": (done / (t_last - t_first)
                    if t_last is not None else None),
            "n_submaps": mapper.n_submaps, "meshes": meshes,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)},
            protocol=4)

    while True:
        active = robot.mapping_enabled and done < frames
        svc.step(timeout_ms=0 if active else 10)
        msg = ctl.poll(0)
        if msg is not None and msg[0] == "req":
            if msg[2] == b"stop":
                ctl.reply(msg[3], b"\x01")
                break
            send_meshes |= msg[2] == b"mesh"
            ctl.reply(msg[3], answer(msg[2]))
        if send_meshes and robot.finished and len(meshes) < mapper.n_submaps:
            k = len(meshes)
            t0 = time.perf_counter()
            m = ms.submap_mesh_msg(robot.state.collection, k,
                                   cfg.intrinsics, client_id=client_id)
            meshes.append({"k": k, "encode_s": time.perf_counter() - t0,
                           "bytes": m.nbytes})
            svc.publish_submap_mesh(m)
        if active:
            f = next(clip)
            if t_first is None:
                t_first = time.perf_counter()
            with robot.lock:
                mapper.step(f.depth, f.color, f.T_odom_cam, f.t)
            svc.publish_timeline()
            done += 1
            if done == frames:
                _fence(device)
                t_last = time.perf_counter()
    svc.bus.close()
    ctl.close()


class _Pump:
    """Steps a ServerService on a thread until ``stop()``."""

    def __init__(self, service):
        self._stop = threading.Event()
        self.errors = []
        self._thread = threading.Thread(target=self._run, args=(service,),
                                        daemon=True)
        self._thread.start()

    def _run(self, service):
        while not self._stop.is_set():
            try:
                service.step(timeout_ms=20)
            except Exception as e:      # reported, not swallowed
                self.errors.append(repr(e))
                return

    def stop(self):
        self._stop.set()
        self._thread.join()


def _wait(pred, timeout: float, what: str, poll=None) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise TimeoutError(f"timed out after {timeout:.0f} s: {what}")
        if poll is not None:
            poll()
        time.sleep(0.02)


def _held_to_robots(server, own):
    """Every server submap against the robot's own copy, ``own(cid, k)`` →
    (coords, sdf, weight) of its live rows → (worst |Δsdf|, worst
    |Δw|/(1 + w) over observed voxels, same blocks and no weight where the
    robot observed none)."""
    spec = server.cfg.spec
    worst_sdf = worst_w = 0.0
    same = True
    for s in server.submaps:
        coords, sdf, w = own(s.client_id, s.client_submap_id)
        slots = vx.lookup_block(spec, s.layer, upload(coords, server.device))
        same &= (int(s.layer.num_blocks) == coords.shape[0]
                 and bool((slots >= 0).all()))
        got_sdf = s.layer.sdf[slots.long()].cpu().numpy()
        got_w = s.layer.weight[slots.long()].cpu().numpy()
        obs = w > 1e-6                          # the serializer's occupancy
        worst_sdf = max(worst_sdf, float(np.abs(got_sdf - sdf)[obs]
                                         .max(initial=0.0)))
        worst_w = max(worst_w, float((np.abs(got_w - w) / (1.0 + w))[obs]
                                     .max(initial=0.0)))
        same &= bool((got_w[~obs] == 0).all())
    return worst_sdf, worst_w, same


def _recover_all(server, cfg, device, keys, trajs):
    """Each pushed mesh (client, submap) in ``keys`` recovered on
    ``device`` by both methods, its mesh held to the scene → (rows of
    bytes and times, all gates held: > 100 triangles and p90 |SDF| < 2
    voxels per method, the message < 0.5 × the submap's voxel wire, and
    on the card K1 once per keyframe for "projective")."""
    from ..comm import mesh_comm, wire
    from ..ops import cuda_tsdf
    from ..ops import mesh as mesh_ops

    spec = cfg.spec
    scene = syn.default_scene(device)
    rows, ok = [], True
    for cid, k in keys:
        msg = server.mesh_collection[(cid, k)]
        s = server.submaps[server.cli_ser[(cid, k)]]
        voxel_bytes = len(wire.serialize_layer(spec, s.layer))
        t0 = time.perf_counter()
        n_kf = len(mesh_comm.decode_to_pointclouds(msg, spec.voxel_size))
        row = {"client": cid, "submap": k, "bytes": msg.nbytes,
               "voxel_bytes": voxel_bytes,
               "decode_ms": 1e3 * (time.perf_counter() - t0)}
        # the submap frame is the robot's camera at the submap's start
        T_w_sm = trajs[cid][int(round(msg.t0 / DT))]
        for method in ("projective", "merged"):
            _fence(device)
            k1 = cuda_tsdf.LAUNCHES
            t0 = time.perf_counter()
            layer = mesh_comm.recover_layer(
                spec, cfg.integrator, cfg.intrinsics, msg, method=method,
                device=device)
            _fence(device)
            row[f"{method}_ms"] = 1e3 * (time.perf_counter() - t0)
            if method == "projective" and device.type == "cuda":
                row["k1_per_keyframe"] = cuda_tsdf.LAUNCHES - k1 == n_kf
            v, _ = mesh_ops.extract_mesh(spec, layer, min_weight=1e-4)
            sdf = syn.scene_sdf(scene, upload(geo.transform_points_np(
                T_w_sm, v.reshape(-1, 3)).astype(np.float32), device))
            row[f"{method}_tris"] = int(v.shape[0])
            row[f"{method}_p90"] = (float(np.quantile(np.abs(
                sdf.cpu().numpy()), 0.9)) if v.shape[0] else math.inf)
            ok &= (row[f"{method}_tris"] > 100
                   and row[f"{method}_p90"] < 2 * spec.voxel_size)
        ok &= (msg.nbytes < 0.5 * voxel_bytes
               and row.get("k1_per_keyframe", True))
        rows.append(row)
    return rows, ok and bool(rows)


def distributed_demo(device=None, frames: int = 40, scale: float = 0.25,
                     reg_weight: float = 30.0, out: Optional[str] = None,
                     configs=None, timeout: float = 300.0) -> dict:
    """The two-robot demo deployed as the reference is: two robot
    processes (spawned, never forked) on ``device`` (None: the card),
    each serving its ``two_robot_experiment`` clip over the native bus,
    and this process running the fusion server over two RemoteClients
    with a ServerService and a RemoteVIO — the flow of
    ``examples/experiment_driver.py``: toggle mapping on, wait until both
    timelines cover mid-run, fuse the two robots there with a
    ground-truth MapFusionMsg (the async solve pushes its poses back into
    the robots while they stream), wait for the whole clip, finish_map
    on each robot, collect every submap, the final global mesh to a PLY
    and the pose history to a TUM file (in ``out``, default a temporary
    directory). Then the mesh-with-history transport: each robot's
    finished submaps arrive on the submap_mesh topic, are combined, and
    every message is recovered with both methods.

    ``configs``: ``demo_configs``' tuple to run instead of the demo's own.
    → the numbers and ``gates`` (each a bool) and ``ok``, the robots'
    MapperConfig (``config``) and one pushed mesh (``sample_mesh``)."""
    import multiprocessing as mp

    from .. import _build, native
    from ..comm import bus as cbus
    from ..frontends import replay

    device = (runtime.require_cuda() if device is None
              else torch.device(device))
    cfg, server_cfg, _, mesh_spec = (configs or demo_configs(
        frames, scale, reg_weight))
    spec = cfg.spec
    # build both libraries here once: the robots load the cached builds
    native.lib()
    if device.type == "cuda":
        _build.load()
        torch.cuda.reset_peak_memory_stats(device)
    _, trajs, X = replay.two_robot_experiment(
        scene=syn.default_scene(device), n_frames=frames,
        intr=cfg.intrinsics, dt=DT)
    tmp = tempfile.TemporaryDirectory() if out is None else None
    out = tmp.name if out is None else out
    os.makedirs(out, exist_ok=True)
    port = free_port()
    broker = cbus.Broker(port)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_robot_main,
                         args=(port, cid, frames, device.type, cfg),
                         daemon=True) for cid in range(2)]
    res: dict = {"frames": frames}
    gates: dict = {}
    pump = ctl = None
    try:
        for p in procs:
            p.start()
        proxies = [cbus.RemoteClient(port, cid, spec, device=device)
                   for cid in range(2)]
        server = fs.CoxgraphServer(server_cfg, proxies, device)
        pump = _Pump(cbus.ServerService(port, server))
        vio = cbus.RemoteVIO(port, timeout_ms=int(timeout * 1000))
        ctl = cbus.BusClient(port)

        def alive():
            dead = [p.exitcode for p in procs if not p.is_alive()]
            if dead:
                raise RuntimeError(f"a robot process exited ({dead})")

        def robot(cid: int, payload: bytes):
            return pickle.loads(ctl.request(f"client{cid}/demo", payload,
                                            int(timeout * 1000)))

        t_start = time.perf_counter()
        for cid in range(2):       # start_mapping.sh: toggle each robot
            _wait(lambda: vio.toggle_mapping(cid, True), timeout,
                  f"robot {cid}'s toggle_mapping service", alive)
        res["robots_up_s"] = time.perf_counter() - t_start

        def covered(t):
            return all(t1 >= t - 1e-5 for _, t1 in
                       (p.timeline() for p in proxies))

        mid = frames // 2
        _wait(lambda: covered(mid * DT), timeout, "mid-run coverage",
              server.time_line_update)
        t0 = time.perf_counter()
        gates["fusion_accepted"] = bool(server.map_fusion(
            true_fusion(trajs, mid, mid, dt=DT)))
        res["fusion_dispatch_s"] = time.perf_counter() - t0
        server.wait_for_optimize()
        res["fusion_to_solution_s"] = time.perf_counter() - t0
        _wait(lambda: covered((frames - 1) * DT), timeout,
              "whole-clip coverage", server.time_line_update)
        for cid in range(2):       # finish_experiment.sh
            gates[f"finish_map_{cid}"] = bool(vio.finish_map(cid))
        res["stream_s"] = time.perf_counter() - t_start

        # every submap pulled once more after finish_map (send-once keeps
        # those that did not change), then held to the robots' own copies
        t0 = time.perf_counter()
        server.collect_all_submaps()
        pull_s = time.perf_counter() - t0
        n_sub = len(server.submaps)
        res["server_submaps"] = n_sub
        res["pull_per_submap_ms"] = 1e3 * pull_s / max(n_sub, 1)
        shipped = [e.n_bytes for p in proxies for e in p.bandwidth.events
                   if e.name.endswith("all_submaps")]
        raw = sum(int(s.layer.num_blocks) * (5 * spec.voxels_per_side ** 3
                                             * 4 + 12)
                  for s in server.submaps)
        res["bytes_per_submap"] = sum(shipped) / max(n_sub, 1)
        res["wire_ratio"] = sum(shipped) / max(raw, 1)
        worst_sdf, worst_w, same_blocks = _held_to_robots(
            server, lambda cid, k: robot(cid, b"own" + struct.pack("<i", k)))
        res["pulled_sdf_err"], res["pulled_weight_rel_err"] = (worst_sdf,
                                                                worst_w)
        # one wire step (plus the f32 rounding of the dequantized value);
        # weights are log-quantized: a step is (1 + w)·ln(1e4 + 1)/65535
        gates["pulled_equals_robots"] = bool(
            same_blocks and worst_sdf <= spec.truncation / 32000
            + 2 * float(np.spacing(np.float32(spec.truncation)))
            and worst_w <= math.log1p(1e4) / 65535 * 1.001)

        t0 = time.perf_counter()
        proxies[0].get_submap_by_time(mid * DT)
        res["submap_round_trip_ms"] = 1e3 * (time.perf_counter() - t0)
        # the robots encode their meshes while the final mesh is built
        for cid in range(2):
            robot(cid, b"mesh")

        ply = os.path.join(out, "coxgraph_server_mesh.ply")
        _fence(device)
        t0 = time.perf_counter()
        _, verts, _ = server.get_final_global_mesh(ply, mesh_spec=mesh_spec)
        _fence(device)
        res["final_mesh_s"] = time.perf_counter() - t0
        res["triangles"] = int(verts.shape[0])
        gates["triangles"] = res["triangles"] > 1000
        traj_path = vio.save_pose_history(out)
        with open(traj_path) as fh:
            res["pose_rows"] = fh.read().count("\n")
        gates["pose_history"] = res["pose_rows"] > 10
        err = geo.se3_log(geo.relative(
            torch.from_numpy(np.asarray(server.T_G_cli[1], np.float32)),
            torch.from_numpy(X[1]))).numpy()
        res["align_err"] = float(np.linalg.norm(err))
        gates["alignment"] = res["align_err"] < ALIGN_GATE
        res["optimize_errors"] = list(server.optimize_errors)
        gates["no_solve_error"] = not server.optimize_errors

        reports = [robot(cid, b"rep") for cid in range(2)]
        if device.type == "cuda":        # K1 launches only on the card
            gates["k1_per_frame"] = all(
                r["k1_launches"] == r["frames"] == frames for r in reports)

        # the mesh-with-history transport
        want = {(cid, k) for cid, r in enumerate(reports)
                for k in range(r["n_submaps"])}
        _wait(lambda: want <= set(server.mesh_collection), timeout,
              "the robots' submap meshes", alive)
        reports = [robot(cid, b"rep") for cid in range(2)]
        res["robots"] = [{k: v for k, v in r.items() if k != "meshes"}
                         for r in reports]
        t0 = time.perf_counter()
        mverts, mfaces, _ = server.combined_submap_mesh(
            ply_path=os.path.join(out, "combined_submap_meshes.ply"))
        res["combined_mesh_ms"] = 1e3 * (time.perf_counter() - t0)
        res["combined_mesh_faces"] = int(mfaces.shape[0])
        res["encode_ms"] = [1e3 * m["encode_s"] for r in reports
                            for m in r["meshes"]]
        rec, mesh_ok = _recover_all(server, cfg, device, sorted(want),
                                    trajs)
        res["recovered"] = rec
        res["config"] = cfg
        res["sample_mesh"] = server.mesh_collection[min(want)]
        gates["mesh_with_history"] = mesh_ok
        if device.type == "cuda":
            res["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        res["server_pump_errors"] = list(pump.errors)
        gates["server_pump"] = not pump.errors
    finally:
        for cid, p in enumerate(procs):
            if ctl is not None and p.is_alive():
                try:
                    ctl.request(f"client{cid}/demo", b"stop", 5000)
                except (TimeoutError, OSError):
                    pass
        for p in procs:
            if p.pid is None:               # never started
                continue
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        if pump is not None:
            pump.stop()
        if ctl is not None:
            ctl.close()
        broker.close()
        if tmp is not None:
            tmp.cleanup()
    res["gates"] = gates
    res["ok"] = bool(gates) and all(gates.values())
    return res


# ---------------------------------------------------------------------------
# Point-cloud mapping (examples/pointcloud_demo.py)
# ---------------------------------------------------------------------------

POINTCLOUD_DT = 0.1


def pointcloud_configs(frames: int, scale: float) -> sm.MapperConfig:
    """examples/pointcloud_demo.py's mapper: 5 cm voxels, 16³ blocks,
    4,096 blocks × 8 submaps, four submaps over the clip."""
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16, grid_dim=64,
                            max_blocks=4096, truncation=0.15)
    return sm.MapperConfig(
        spec=spec,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=2048),
        intrinsics=syn.PinholeIntrinsics().scaled(scale), max_submaps=8,
        max_history=64, submap_interval=frames * POINTCLOUD_DT / 4)


def pointcloud_demo(device=None, frames: int = 24, scale: float = 0.25,
                    out: Optional[str] = None, cfg=None) -> dict:
    """A robot streaming UNORDERED clouds (rendered depth backprojected,
    then shuffled with numpy's seed 0) through ``HostMapper.step_points``
    on ``device`` (None: the card), then the merged map's mesh against
    the analytic scene → submaps, integration wall, triangles, surface
    error p90 and ``ok`` (≥ 3 submaps, > 1,000 triangles, p90 < 2
    voxels). With ``out`` the mesh PLY is written there."""
    from ..ops import mesh as mesh_ops
    from ..ops import points as pts_ops

    device = (runtime.require_cuda() if device is None
              else torch.device(device))
    cfg = cfg or pointcloud_configs(frames, scale)
    intr, spec = cfg.intrinsics, cfg.spec
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(frames, scene.room_center.cpu(), radius=2.5)
    traj_np = traj.numpy()
    mapper = sm.HostMapper(cfg, device=device)
    rng = np.random.default_rng(0)
    _fence(device)
    t0 = time.perf_counter()
    for i in range(frames):
        depth, color = syn.render_depth(scene, intr, traj[i].to(device))
        perm = torch.from_numpy(rng.permutation(depth.numel())).to(device)
        p = pts_ops.backproject(intr, depth).reshape(-1, 3)[perm]
        c = color.reshape(-1, 3)[perm]
        m = depth.reshape(-1)[perm] > 0.1
        mapper.step_points(p, c, m, traj_np[i], i * POINTCLOUD_DT)
    _fence(device)
    res = {"clouds": frames, "points_per_cloud": intr.width * intr.height,
           "integrate_s": time.perf_counter() - t0,
           "submaps": mapper.n_submaps}
    merged = sm.merged_layer(cfg, mapper.state.collection)
    verts, cols = mesh_ops.extract_mesh(spec, merged, min_weight=1e-4)
    if out:
        os.makedirs(out, exist_ok=True)
        export.write_ply(os.path.join(out, "pointcloud_map.ply"), verts,
                         cols)
    sdf = syn.scene_sdf(scene, upload(np.ascontiguousarray(
        verts.reshape(-1, 3)), device)).cpu().numpy()
    res["triangles"] = int(verts.shape[0])
    res["surf_p90"] = (float(np.quantile(np.abs(sdf), 0.9))
                       if verts.shape[0] else math.inf)
    res["ok"] = bool(res["submaps"] >= 3 and res["triangles"] > 1000
                     and res["surf_p90"] < 2.0 * spec.voxel_size)
    return res


# ---------------------------------------------------------------------------
# The single-robot demo (examples/single_robot_demo.py)
# ---------------------------------------------------------------------------

SINGLE_DT = 0.05     # s between frames (20 Hz, the reference's assumption)


def single_robot_config(frames: int, scale: float) -> sm.MapperConfig:
    """examples/single_robot_demo.py's mapper: 5 cm voxels, 16³ blocks,
    4,096 blocks × 16 submaps, 2,048 touched blocks, ~8 submaps a clip."""
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16, grid_dim=64,
                            max_blocks=4096, truncation=0.15)
    return sm.MapperConfig(
        spec=spec,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=2048),
        intrinsics=syn.PinholeIntrinsics().scaled(scale),
        max_submaps=16, max_history=256,
        submap_interval=frames * SINGLE_DT / 8)


def single_robot_demo(device=None, frames: int = 60, scale: float = 0.25,
                      out: Optional[str] = None, odom=None,
                      cfg: Optional[sm.MapperConfig] = None) -> dict:
    """The single-robot demo on ``device`` (None: the card): an orbit of
    ``frames`` frames rendered on the device, odometry drifting from it
    (torch's seed 0, 0.004 rad / 1 cm a step; ``odom`` (frames, 7) numpy
    replaces it), one ``HostMapper.step`` a frame, the ground-truth loop
    closure between the first and the last submap, ``optimize_local``
    (20 iterations), ``merged_layer`` and its mesh (min weight 0.1)
    against the analytic scene. The PLY and TUM files go to ``out``
    (default a temporary directory). ``cfg`` replaces
    ``single_robot_config`` (the tests' small pools).

    → frames, submaps, integration wall and frames/s, ATE of the raw and
    the optimized trajectory (m, no alignment), merged blocks, triangles,
    surface error p90 (m), the timers, the trajectory's stamps and poses
    before and after the solve (numpy), and ``ok``: the JAX demo's gate,
    ATE after < max(2.5 × before, 0.08 m) and > 1,000 triangles."""
    from ..ops import mesh as mesh_ops
    from ..solver import pose_graph as pg

    device = (runtime.require_cuda() if device is None
              else torch.device(device))
    cfg = cfg or single_robot_config(frames, scale)
    dt = SINGLE_DT
    scene = syn.default_scene(device)
    traj = syn.orbit_trajectory(frames, scene.room_center.cpu(), radius=2.5)
    traj_np = traj.numpy()
    if odom is None:
        odom = syn.noisy_odometry(torch.Generator().manual_seed(0), traj,
                                  rot_std=0.004, trans_std=0.01).numpy()
    odom_np = np.asarray(odom, np.float32)

    timers = runtime.Timers()
    mapper = sm.HostMapper(cfg, device=device)
    fence = mapper.state.frame_count
    _fence(device)
    t0 = time.perf_counter()
    for i in range(frames):
        with timers.scope("render", sync=fence):
            depth, color = syn.render_depth(scene, cfg.intrinsics,
                                            upload(traj_np[i], device))
        with timers.scope("mapper_step", sync=fence):
            mapper.step(depth, color, odom_np[i], i * dt)
    wall = time.perf_counter() - t0
    state, ns = mapper.state, mapper.n_submaps
    col = state.collection

    gt_stamps = np.arange(frames) * dt
    stamps, poses_raw = (x.cpu().numpy() for x in sm.trajectory(col))
    ate_raw = metrics.ate_rmse(stamps, poses_raw, gt_stamps, traj_np,
                               align=False)
    # the loop closure: the ground-truth relative pose between the first
    # and the last submap (detection is the two-robot demo's)
    start = col.start_time.cpu().numpy()
    frame_of = [int(round(float(start[k]) / dt)) for k in range(ns)]
    T_true = traj_np[frame_of]
    sm.add_loop_closure(state, 0, ns - 1,
                        upload(geo.relative_np(T_true[0], T_true[ns - 1]),
                               device),
                        50.0 * torch.eye(6, device=device))
    with timers.scope("local_pgo", sync=fence):
        sm.optimize_local(cfg, state, pg.SolverConfig(iterations=20))
    stamps_opt, poses_opt = (x.cpu().numpy() for x in sm.trajectory(col))
    ate_opt = metrics.ate_rmse(stamps_opt, poses_opt, gt_stamps, traj_np,
                               align=False)

    with timers.scope("merge", sync=fence):
        merged = sm.merged_layer(cfg, col)
    with timers.scope("mesh"):
        verts, cols = mesh_ops.extract_mesh(cfg.spec, merged, min_weight=0.1)
    sdf = np.abs(syn.scene_sdf(scene, upload(np.ascontiguousarray(
        verts.reshape(-1, 3)), device)).cpu().numpy())

    tmp = tempfile.TemporaryDirectory() if out is None else None
    out_dir = tmp.name if out is None else out
    os.makedirs(out_dir, exist_ok=True)
    export.write_ply(os.path.join(out_dir, "global_mesh.ply"), verts, cols)
    export.write_tum_trajectory(os.path.join(out_dir, "trajectory.tum"),
                                stamps_opt, poses_opt)
    if tmp is not None:
        tmp.cleanup()
    n_tris = int(verts.shape[0])
    return {"frames": frames, "submaps": ns, "integrate_s": wall,
            "fps": frames / wall, "ate_raw": ate_raw, "ate_opt": ate_opt,
            "merged_blocks": int(merged.num_blocks), "triangles": n_tris,
            "surf_p90": (float(np.quantile(sdf, 0.9)) if n_tris
                         else math.inf),
            "timers": json.loads(timers.as_json()),
            "stamps": stamps, "poses_raw": poses_raw,
            "poses_opt": poses_opt,
            "ok": bool(ate_opt < max(2.5 * ate_raw, 0.08)
                       and n_tris > 1000)}


# ---------------------------------------------------------------------------
# Real RGB-D sequences: tests/test_tum_replay.py and tests/test_real_replay.py
# ---------------------------------------------------------------------------


def _tum_spec() -> vx.VoxelGridSpec:
    """The real-data grid: 0.1 m voxels, 8³ blocks, 1,024 blocks."""
    return vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                            max_blocks=1024, truncation=0.3)


def tum_tiny_config() -> sm.MapperConfig:
    """``tests/test_tum_replay.py``'s CFG (:20-26): 80×60, 8 submaps of
    64 poses, a submap every 0.35 s."""
    return sm.MapperConfig(
        spec=_tum_spec(),
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512),
        intrinsics=syn.PinholeIntrinsics().scaled(0.125),
        max_submaps=8, max_history=64, submap_interval=0.35)


def _drift_mapper_config(**kw) -> sm.MapperConfig:
    """The drift tests' mapper: 160×120, 20 submaps of 48 poses, a submap
    a second, height priors at 0.1 m."""
    return sm.MapperConfig(
        spec=_tum_spec(),
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512),
        intrinsics=syn.PinholeIntrinsics().scaled(0.25),
        max_submaps=20, max_history=48, submap_interval=1.0,
        height_prior_stddev=0.1, **kw)


def tum_loop_config():
    """(MapperConfig, LoopDetectorConfig, drift recipe) of
    ``tests/test_tum_replay.py::test_tum_loop_drift_correction``: the
    mapper of :125-133, the detector of :160-166 (K = 384, a keyframe
    every 0.4 s, closures weighted 100) and the bias of :140-152."""
    det = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=384),
        min_match_score=25, min_inliers=15,
        keyframe_stride=0.4, min_time_separation=5.0, sqrt_info=100.0)
    return (_drift_mapper_config(), det,
            {"yaw_bias": 0.0045, "fwd_bias": 0.0045})


def tum_real_config():
    """(MapperConfig, LoopDetectorConfig, drift recipe) of
    ``tests/test_real_replay.py::test_real_texture_drift_correction``: the
    mapper of :63-74 (the local solve with Huber at 1.5), the detector of
    :107-112 (K = 512, a 0.1 s keyframe stride, 3 candidates) and the bias
    of :80-92."""
    from ..solver import pose_graph as pg

    det = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=512),
        min_match_score=16, min_inliers=10, min_inlier_spread=0.4,
        max_candidates=3, keyframe_stride=0.1, min_time_separation=4.0,
        sqrt_info=100.0)
    return (_drift_mapper_config(
        local_solver=pg.SolverConfig(huber_delta=1.5)), det,
        {"yaw_bias": 0.009, "fwd_bias": 0.009})


REPLAY_POINTS = {"tum_loop": tum_loop_config, "tum_real": tum_real_config}
# the JAX tests' gates: drifted ATE above, closures and routed closures at
# least, corrected ATE below ratio × drifted and below max_corrected (m)
REPLAY_GATES = {
    "tum_loop": {"min_drifted": 0.045, "min_closures": 1, "min_routed": 1,
                 "ratio": 0.75, "max_corrected": math.inf},
    "tum_real": {"min_drifted": 0.08, "min_closures": 10, "min_routed": 10,
                 "ratio": 0.8, "max_corrected": 0.10},
}
TINY_ATE_GATE = 5e-3      # m, tum_tiny's trajectory against groundtruth.txt
TINY_SURFACE_GATE = 3.0   # voxels, tum_tiny's mesh surface q90


def drifted_odometry(gt, seed: int = 11, sigma: float = 0.0015,
                     yaw_bias: float = 0.0, fwd_bias: float = 0.0
                     ) -> np.ndarray:
    """The drift tests' odometry (``test_tum_replay.py:140-152``,
    ``test_real_replay.py:80-92``): each ground-truth relative motion of
    ``gt`` (N,7) composed with ``se3_exp`` of numpy noise (seed ``seed``,
    σ ``sigma``) plus ``yaw_bias`` on rz and ``fwd_bias`` on x, chained
    from ``gt[0]`` → (N,7) f32. The reference's geometry, small angles
    included."""
    rng = np.random.default_rng(seed)
    gt = [np.asarray(T, np.float32) for T in gt]
    drifted = [gt[0]]
    for k in range(1, len(gt)):
        T_rel = geo.relative_np(gt[k - 1], gt[k])
        noise = rng.normal(0, sigma, 6).astype(np.float32)
        noise[2] += yaw_bias
        noise[3] += fwd_bias
        T_rel = geo.compose_np(T_rel,
                               geo.se3_exp(torch.from_numpy(noise)).numpy())
        drifted.append(geo.compose_np(drifted[-1], T_rel))
    return np.stack(drifted)


def tum_pipeline(root: str, device=None) -> dict:
    """``tests/test_tum_replay.py::test_tum_replay_full_pipeline`` on
    ``device`` (None: the card): the TUM directory ``root`` through
    ``TumRgbdReplay`` and ``HostMapper.step`` at ``tum_tiny_config``, the
    trajectory's ATE against groundtruth.txt (Umeyama-aligned, 20 ms
    association), the merged map's mesh (min weight 0.1) against the
    analytic scene.

    → frames, submaps, ATE (m), mesh vertices, surface q90 (m), host
    seconds decoding / uploading / stepping (a fence a step), the
    trajectory (numpy), the mapper, and ``ok``: the JAX test's gates
    (ATE < 5 mm, ≥ 2 submaps, > 300 vertices, q90 < 3 voxels)."""
    from ..frontends import replay
    from ..ops import mesh as mesh_ops

    device = (runtime.require_cuda() if device is None
              else torch.device(device))
    cfg = tum_tiny_config()
    rp = replay.TumRgbdReplay(root, intr=cfg.intrinsics, device=device)
    mapper = sm.HostMapper(cfg, device=device)
    n, step_s = 0, 0.0
    for f in rp:
        t0 = time.perf_counter()
        mapper.step(f.depth, f.color, f.T_odom_cam, f.t)
        _fence(device)
        step_s += time.perf_counter() - t0
        n += 1
    col = mapper.state.collection
    stamps, poses = (x.cpu().numpy() for x in sm.trajectory(col))
    stamps_gt, poses_gt = rp.groundtruth()
    ate = metrics.ate_rmse(stamps, poses, stamps_gt, poses_gt, max_dt=0.02)
    layer = sm.merged_layer(cfg, col)
    verts, _ = mesh_ops.extract_mesh(cfg.spec, layer, min_weight=0.1)
    pts = np.ascontiguousarray(verts.reshape(-1, 3))
    scene = syn.default_scene(device)
    sdf = np.abs(syn.scene_sdf(scene, upload(pts, device)).cpu().numpy())
    q90 = float(np.quantile(sdf, 0.9)) if len(pts) else math.inf
    return {"frames": n, "submaps": mapper.n_submaps, "ate": ate,
            "vertices": int(pts.shape[0]), "surf_q90": q90,
            "decode_s": rp.decode_s, "upload_s": rp.upload_s,
            "step_s": step_s, "stamps": stamps, "poses": poses,
            "mapper": mapper,
            "ok": bool(ate < TINY_ATE_GATE and mapper.n_submaps >= 2
                       and pts.shape[0] > 300
                       and q90 < TINY_SURFACE_GATE * cfg.spec.voxel_size)}


def replay_inputs(root: str, point: str, device=None):
    """The drift tests' inputs for the TUM directory ``root`` at the
    operating point ``point`` ("tum_loop" or "tum_real") → (MapperConfig,
    LoopDetectorConfig, the replay on ``device`` (None: the card), the
    frames' stamps (N,), ground truth (N,7) and drifted odometry (N,7))."""
    from ..frontends import replay

    device = (runtime.require_cuda() if device is None
              else torch.device(device))
    cfg, det_cfg, drift = REPLAY_POINTS[point]()
    rp = replay.TumRgbdReplay(root, intr=cfg.intrinsics, device=device)
    assoc = rp.associations()
    stamps = np.asarray([a[0] for a in assoc])
    gt = np.stack([a[3] for a in assoc])
    return cfg, det_cfg, rp, stamps, gt, drifted_odometry(gt, **drift)


def map_drifted(rp, drifted, cfg: sm.MapperConfig,
                det_cfg: Optional[ld.LoopDetectorConfig], device,
                generator: Optional[torch.Generator] = None):
    """The frames of the replay ``rp`` through ``HostMapper.step`` at the
    odometry ``drifted`` (N,7), and each through
    ``LoopDetector.add_keyframe(0, t, color, depth)``: the drift tests'
    loop → (mapper, detector, closures, stats). ``det_cfg`` None maps
    without a detector, for routing closures made elsewhere. ``stats``:
    frames, keyframes, host seconds stepping and detecting (a fence after
    each call), K1 and K2 launches."""
    from ..ops import cuda_hamming, cuda_tsdf

    mapper = sm.HostMapper(cfg, device=device)
    det = (None if det_cfg is None
           else ld.LoopDetector(cfg.intrinsics, det_cfg, device))
    k1, k2 = cuda_tsdf.LAUNCHES, cuda_hamming.LAUNCHES
    closures, n, step_s, detect_s = [], 0, 0.0, 0.0
    for f, T in zip(rp, drifted):
        t0 = time.perf_counter()
        mapper.step(f.depth, f.color, np.asarray(T, np.float32), f.t)
        _fence(device)
        t1 = time.perf_counter()
        step_s += t1 - t0
        n += 1
        if det is None:
            continue
        closures.extend(det.add_keyframe(0, f.t, f.color, f.depth,
                                         generator=generator))
        _fence(device)
        detect_s += time.perf_counter() - t1
    return mapper, det, closures, {
        "frames": n, "keyframes": 0 if det is None else det.total_keyframes,
        "step_s": step_s, "detect_s": detect_s,
        "k1_launches": cuda_tsdf.LAUNCHES - k1,
        "k2_launches": cuda_hamming.LAUNCHES - k2}


def intra_client_server(cfg: sm.MapperConfig, mapper: sm.HostMapper,
                        device):
    """The drift tests' server: an ``InProcessClient`` over the mapper's
    state (its ``mapper`` hook set, so each local solve refreshes the
    mapper's pose mirror) behind a ``CoxgraphServer`` with no refuse
    interval → (client, server)."""
    client = InProcessClient(0, cfg, mapper.state)
    client.mapper = mapper
    return client, fs.CoxgraphServer(
        fs.ServerConfig(spec=cfg.spec, refuse_interval=0.0), [client],
        device)


def route_closures(cfg: sm.MapperConfig, mapper: sm.HostMapper, closures,
                   device):
    """The drift tests' routing: ``map_fusion`` of every closure on an
    ``intra_client_server`` — the intra-client branch, then
    ``receive_loop_closure`` and ``optimize_local`` (a fence after each
    call) → (client, routed flags, stats). ``stats``: host seconds
    routing, and the largest |Δ| between the mapper's pose mirror and the
    device's submap poses after the last solve."""
    client, server = intra_client_server(cfg, mapper, device)
    flags, route_s = [], 0.0
    for mf in closures:
        t0 = time.perf_counter()
        flags.append(bool(server.map_fusion(mf)))
        _fence(device)
        route_s += time.perf_counter() - t0
    col = mapper.state.collection
    dev_T = col.T_odom_submap[:mapper.n_submaps].cpu().numpy()
    host_T = np.stack(mapper.host_T_odom_submap)
    return client, flags, {
        "route_s": route_s,
        "mirror_err": float(np.abs(dev_T - host_T).max())}


def drift_correction(root: str, point: str, device=None,
                     generator: Optional[torch.Generator] = None) -> dict:
    """SLAM under drift on a TUM directory (``point`` "tum_loop": the flow
    of ``tests/test_tum_replay.py::test_tum_loop_drift_correction``;
    "tum_real": ``tests/test_real_replay.py::
    test_real_texture_drift_correction``) on ``device`` (None: the card):
    ``replay_inputs``, ``map_drifted`` with the point's detector (RANSAC
    drawing from ``generator``, else the detector's seeded one),
    ``route_closures``, then the client's pose history against the ground
    truth (``metrics.ate_rmse``, aligned).

    → frames, keyframes, closures, routed, ATE drifted and corrected (m),
    host seconds decoding / uploading / stepping / detecting / routing,
    ms per keyframe of detection and per routed closure of routing plus
    its local solve, K1 and K2 launches, the pose mirror's error, ``ok``
    (the JAX test's gates, ``REPLAY_GATES``) and, for further checks, the
    mapper, detector, client and closures."""
    cfg, det_cfg, rp, stamps, gt, drifted = replay_inputs(root, point,
                                                          device)
    device = rp.device
    ate_drifted = metrics.ate_rmse(stamps, drifted, stamps, gt)
    mapper, det, closures, st = map_drifted(rp, drifted, cfg, det_cfg,
                                            device, generator)
    client, flags, rt = route_closures(cfg, mapper, closures, device)
    stamps_c, poses_c = client.get_pose_history()
    ate_corrected = metrics.ate_rmse(stamps_c, poses_c, stamps, gt)
    routed = sum(flags)
    g = REPLAY_GATES[point]
    ok = (ate_drifted > g["min_drifted"]
          and len(closures) >= g["min_closures"]
          and routed >= g["min_routed"]
          and ate_corrected < g["ratio"] * ate_drifted
          and ate_corrected < g["max_corrected"]
          and rt["mirror_err"] == 0.0)
    kf = max(st["keyframes"], 1)
    return {"point": point, "frames": st["frames"],
            "keyframes": st["keyframes"], "closures": len(closures),
            "routed": routed, "ate_drifted": ate_drifted,
            "ate_corrected": ate_corrected, "decode_s": rp.decode_s,
            "upload_s": rp.upload_s, "step_s": st["step_s"],
            "detect_s": st["detect_s"], "route_s": rt["route_s"],
            "detect_ms_per_keyframe": 1e3 * st["detect_s"] / kf,
            "route_ms_per_routed": 1e3 * rt["route_s"] / max(routed, 1),
            "k1_launches": st["k1_launches"],
            "k2_launches": st["k2_launches"],
            "mirror_err": rt["mirror_err"], "ok": bool(ok),
            "routed_flags": flags, "closure_msgs": closures,
            "mapper": mapper, "detector": det, "client": client}
