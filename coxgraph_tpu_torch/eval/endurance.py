"""The endurance mission — port of the body of ``tools/endurance_run.py``:
two robots stream laps of an orbit with drifting odometry through the
whole pipeline, its stages running concurrently as the reference's
processes do (tsdf_server → tsdf_recover → client → server,
firefly/tsdf_client.launch:25-50, the global solve on a detached
std::async, coxgraph_server.cpp:471-473):

  stream (the caller's thread) — one ``step_batch`` window per robot
      under its client lock, then the deferred local PGO; it never waits
      on a fusion, a solve or a mesh readback;
  serving — robot 0's live mesh once a lap: ``live_mesh_async`` under
      the client lock, its ``finish()`` (the extraction and readback) off
      it; queued requests coalesce;
  detector — keyframe jobs from a queue, batched ingest (K2), fusions to
      the server with non-blocking PGO;
  solve — the server's async PGO, which pushes poses under the client
      locks.

Every thread issues its work on the process's one default stream. That
orders the serving thread's copy of the layer (``get_layer``, under the
lock) before the stream thread's next in-place K1 update, which is what
lets ``finish()`` run off the lock. A side stream would need events and
``record_stream`` on every shared tensor.

Changes from the JAX script: both robots' 96-frame laps are rendered
once on the device (no CPU subprocess, no frame cache); the JSON goes to
``chiprun_out/endurance_torch.json`` by default (never over the TPU's
``ENDURANCE_r0*.json`` records) and gains ``device``; and three faults of
the script are fixed:

  * the serving loop records each error and serves the next request (the
    script's loop ends for good on its first exception);
  * ``stage_wall_s["live_mesh"]`` starts once the client lock is held;
    the wait for it is ``stage_wall_s["live_mesh_lock_wait"]``;
  * the gate also bounds the final mesh's surface error p90 at 4 voxels
    (``demos.SURFACE_GATE``).
"""

from __future__ import annotations

import json
import math
import os
import queue
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import runtime
from ..comm import mesh_comm, wire
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends import loop_detector as ld
from ..frontends import synthetic as syn
from ..mapper import submap_mapper as sm
from ..ops import features as ft
from ..ops import registration as reg
from ..ops import tsdf as tsdf_ops
from ..server import fusion_server as fs
from ..server.client_interface import InProcessClient
from ..solver import pose_graph as pg
from ..utils.tensorops import f32_reciprocal, upload
from . import metrics
from .demos import SURFACE_GATE, _fence
from .live_view import LiveMeshViewer

DT = 0.1            # s between frames: each robot's sensor runs at 10 Hz
N_LAP = 96          # frames per lap per robot (one full orbit)
WINDOW = 24         # frames per step_batch dispatch
KF_STRIDE = 4       # frames between detector keyframes
ATE_GATE = 0.25     # m, the script's gate
JOIN_TIMEOUT = 600.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "endurance_torch.json")


def endurance_configs(scale: float = 0.25, window: int = WINDOW):
    """(MapperConfig, ServerConfig, LoopDetectorConfig, final-mesh spec) of
    the JAX script (tools/endurance_run.py:165-253): 5 cm voxels, 16³
    blocks, 1,024 blocks × 20 submaps a robot with a submap every window
    (at 6 laps the 24 rollovers overrun the pool on purpose), height
    priors, a 48-submap server with non-blocking async PGO, the detector
    at K = 384 with 512 slots, the final mesh at 6,144 blocks."""
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16, grid_dim=64,
                            max_blocks=1024, truncation=0.15)
    cfg = sm.MapperConfig(
        spec=spec,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512),
        intrinsics=syn.PinholeIntrinsics().scaled(scale),
        max_submaps=20, max_history=512,
        submap_interval=window * DT,
        height_prior_stddev=0.1,
        local_solver=pg.SolverConfig(huber_delta=1.5))
    server_cfg = fs.ServerConfig(
        spec=spec, max_submaps=48, refuse_interval=2.0,
        intra_refuse_interval=2.0,
        async_pgo=True, nonblocking_pgo=True,
        min_solve_interval=6.0,
        max_registration_pairs=96,
        registration_weight=30.0,
        registration=reg.RegistrationConfig(
            max_points=512, iterations=8, max_reg_blocks=512,
            phase2_dispatch_iters=1))
    det_cfg = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=384),
        min_match_score=25, min_inliers=15,
        keyframe_stride=KF_STRIDE * DT, min_time_separation=6.0,
        sqrt_info=100.0, max_keyframes=512,
        batch_size=8, match_chunk=64)
    mesh_spec = vx.VoxelGridSpec(
        voxel_size=spec.voxel_size, voxels_per_side=16, grid_dim=64,
        max_blocks=6144, truncation=spec.truncation)
    return cfg, server_cfg, det_cfg, mesh_spec


def lap_trajectories(n_lap: int = N_LAP):
    """Both robots' ground-truth laps ((n_lap, 7) numpy each): radius 2.4
    orbits of the room centre starting at angles 0 and π."""
    center = syn.default_scene(torch.device("cpu")).room_center
    return [syn.orbit_trajectory(n_lap, center, radius=2.4,
                                 sweep=2 * math.pi, start_angle=a).numpy()
            for a in (0.0, math.pi)]


def endurance_odometry(trajs, n_frames: int, seed: int = 3):
    """The script's drifting odometry (tools/endurance_run.py:184-202):
    each robot's relative motions, frame to frame over the repeated laps,
    perturbed by ``se3_exp`` of numpy ``default_rng(seed)`` noise
    (σ = 0.8 mm / mrad, biased by +0.8 mm in z and +1 mrad in roll),
    robot 0's draws first, then expressed in each robot's own odom frame
    (robot 1's moved by (0.8, -0.4, 0) m and a 0.5 rad yaw) → (ground
    truth [(n_frames, 7)] × 2, odometry [(n_frames, 7)] × 2) numpy."""
    rng = np.random.default_rng(seed)
    X = [geo.identity_np(),
         geo.from_xyzyaw(torch.tensor([0.8, -0.4, 0.0, 0.5])).numpy()]
    gt_all, odom_all = [], []
    for r in range(2):
        n_lap = trajs[r].shape[0]
        gt = [trajs[r][i % n_lap] for i in range(n_frames)]
        od = [gt[0]]
        for k in range(1, n_frames):
            T_rel = geo.relative_np(gt[k - 1], gt[k])
            noise = rng.normal(0, 0.0008, 6).astype(np.float32)
            noise[2] += 0.0008
            noise[3] += 0.0010
            T_rel = geo.compose_np(
                T_rel, geo.se3_exp(torch.from_numpy(noise)).numpy())
            od.append(geo.compose_np(od[-1], T_rel))
        gt_all.append(np.stack(gt))
        X_inv = geo.inverse_np(X[r])
        odom_all.append(np.stack([geo.compose_np(X_inv, p) for p in od]))
    return gt_all, odom_all


def mission_gates(art: dict, voxel_size: float) -> dict:
    """The mission's gates on its JSON: no error from any thread or solve,
    at least one fusion, max ATE < 0.25 m, > 1,000 triangles, surface
    error p90 < 4 voxels, every thread joined."""
    return {
        "no_error": not art["optimize_errors"],
        "fusion": art["fusions_accepted"] > 0,
        "ate": max(art["ate_m"]) < ATE_GATE,
        "triangles": art["final_mesh_tris"] > 1000,
        "surface": art["surface_err_p90_m"] < SURFACE_GATE * voxel_size,
        "threads_joined": bool(art["threads_joined"]),
    }


class EnduranceMission:
    """The mission's world on ``device`` (None: the card): both laps
    rendered there (colour staged as uint8), the odometry, two
    ``InProcessClient``s with ``HostMapper``s, the server, the detector
    and the live-mesh viewer. ``run()`` is the whole mission; its parts
    (``start``, ``stream``, ``drain``, ``finish``) and the thread bodies
    are methods so that a test can drive them apart.

    ``n_lap`` and ``window`` cut the lap and the dispatch window (the
    tests' small mission); ``configs`` is ``endurance_configs``' tuple to
    run instead; ``work_dir`` receives the viewer's page and the final
    mesh PLY (default a temporary directory)."""

    def __init__(self, device=None, laps: int = 6, paced: bool = False,
                 no_loops: bool = False, scale: float = 0.25,
                 n_lap: int = N_LAP, window: int = WINDOW, configs=None,
                 work_dir: Optional[str] = None):
        if n_lap % window:
            raise ValueError(f"a lap of {n_lap} frames does not split into "
                             f"windows of {window}")
        self.device = (runtime.require_cuda() if device is None
                       else torch.device(device))
        self.laps, self.paced, self.no_loops = laps, paced, no_loops
        self.n_lap, self.window = n_lap, window
        self.n_frames = laps * n_lap
        self.cfg, server_cfg, det_cfg, self.mesh_spec = (
            configs or endurance_configs(scale, window))
        self._tmp = tempfile.TemporaryDirectory() if work_dir is None \
            else None
        self.work_dir = self._tmp.name if work_dir is None else work_dir
        os.makedirs(self.work_dir, exist_ok=True)

        self.scene = syn.default_scene(self.device)
        trajs = lap_trajectories(n_lap)
        # both laps staged on the device once, colour as uint8 (the
        # script's frame cache); windows and keyframes are views of them
        self.depths, self.colors = [], []
        for r in range(2):
            fr = [syn.render_depth(self.scene, self.cfg.intrinsics,
                                   upload(trajs[r][i], self.device))
                  for i in range(n_lap)]
            self.depths.append(torch.stack([f[0] for f in fr]))
            self.colors.append((torch.stack([f[1] for f in fr]) * 255.0)
                               .clamp(0, 255).to(torch.uint8))
        self.gt, self.odom = endurance_odometry(trajs, self.n_frames)

        cfg = self.cfg
        self.clients = [InProcessClient(r, cfg, sm.create_mapper(
            cfg, self.device)) for r in range(2)]
        self.mappers = [sm.HostMapper(cfg, c.state) for c in self.clients]
        for c, m in zip(self.clients, self.mappers):
            c.defer_local_pgo = True    # closures add; the stream solves
            # the client serves timelines, handles and poses from the
            # mapper's host mirror (no device read on the fusion path)
            c.mapper = m
        self.server = fs.CoxgraphServer(server_cfg, self.clients,
                                        self.device)
        self.detector = ld.LoopDetector(cfg.intrinsics, det_cfg, self.device)
        self.viewer = LiveMeshViewer(self.work_dir, label="endurance")

        self.kf_jobs: queue.Queue = queue.Queue()
        self.serve_jobs: queue.Queue = queue.Queue()
        self.stage = {"integrate": 0.0, "live_mesh": 0.0,
                      "live_mesh_lock_wait": 0.0, "local_pgo": 0.0,
                      "detect": 0.0, "fuse": 0.0}
        self.counts = {"cand": 0, "fused": 0, "kf": 0, "windows": 0}
        self.serve_counts = {"updates": 0}
        self.errors: list = []          # the detector's and serving's
        self.kf_queue_max = 0
        self.max_window_lag = 0.0
        self.threads: list = []
        self.t_start = None
        self.stream_wall = self.drain_wall = self.pipeline_wall = None

    # -- staged frames ---------------------------------------------------

    def window_at(self, r: int, w0: int):
        """Robot ``r``'s window of lap frames from ``w0`` → (depths,
        colours in [0, 1])."""
        sl = slice(w0, w0 + self.window)
        return (self.depths[r][sl],
                self.colors[r][sl].to(torch.float32) * f32_reciprocal(255.0))

    def frame_at(self, r: int, k: int):
        return (self.depths[r][k],
                self.colors[r][k].to(torch.float32) * f32_reciprocal(255.0))

    # -- threads -----------------------------------------------------------

    def detector_loop(self) -> None:
        """Keyframe jobs → batched ingest (up to 16 queued keyframes) →
        fusions. An error ends the loop and is recorded."""
        try:
            while True:
                job = self.kf_jobs.get()
                if job is None:
                    return
                batch = [job]
                while len(batch) < 16:
                    try:
                        j2 = self.kf_jobs.get_nowait()
                    except queue.Empty:
                        break
                    if j2 is None:
                        self.kf_jobs.put(None)   # re-post the sentinel
                        break
                    batch.append(j2)
                t0 = time.perf_counter()
                items = []
                for r, k, t in batch:
                    dk, ck = self.frame_at(r, k)
                    items.append((r, t, ck, dk))
                mfs = self.detector.add_keyframes_batch(items)
                self.stage["detect"] += time.perf_counter() - t0
                self.counts["kf"] += len(batch)
                for mf in mfs:
                    self.counts["cand"] += 1
                    t0 = time.perf_counter()
                    if self.server.map_fusion(mf):
                        self.counts["fused"] += 1
                    self.stage["fuse"] += time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — recorded, fails the gate
            self.errors.append(f"{type(e).__name__}: {e}")

    def serving_loop(self) -> None:
        """Live-mesh requests (queued ones coalesce: dirty bits
        accumulate) → one ``serve_once`` each. An error is recorded and
        the loop serves the next request."""
        while True:
            job = self.serve_jobs.get()
            if job is None:
                return
            while True:
                try:
                    j2 = self.serve_jobs.get_nowait()
                except queue.Empty:
                    break
                if j2 is None:
                    self.serve_jobs.put(None)    # re-post the sentinel
                    break
            try:
                self.serve_once()
            except Exception as e:  # noqa: BLE001 — recorded, fails the gate
                self.errors.append(f"serving: {type(e).__name__}: {e}")

    def serve_once(self) -> None:
        """Robot 0's active submap: its dirty bits consumed and its layer
        copied under the client lock (device work only), then re-meshed
        and read back off the lock (min weight 0.1, a fixed triangle
        buffer). The wait for the lock is timed apart."""
        client, mapper = self.clients[0], self.mappers[0]
        t_wait = time.perf_counter()
        with client.lock:
            t0 = time.perf_counter()
            self.stage["live_mesh_lock_wait"] += t0 - t_wait
            mapper.state = client.state
            finish = mapper.live_mesh_async(min_weight=0.1,
                                            max_tris=1 << 20)
            client.state = mapper.state
        v_live, c_live = finish()
        self.viewer.update(v_live.reshape(-1, 3),
                           np.round(np.clip(c_live.reshape(-1, 3), 0, 1)
                                    * 255).astype(np.uint8))
        self.stage["live_mesh"] += time.perf_counter() - t0
        self.serve_counts["updates"] += 1

    def start(self) -> None:
        """Start the detector and serving threads (the solve thread is
        the server's)."""
        self.threads = [threading.Thread(target=f, daemon=True)
                        for f in (self.detector_loop, self.serving_loop)]
        for t in self.threads:
            t.start()

    # -- the stream thread ---------------------------------------------------

    def stream_window(self, lap: int, w0: int) -> None:
        """One window of both robots, the deferred local solves, and the
        window's keyframes handed to the detector."""
        i0 = lap * self.n_lap + w0
        ts = (np.arange(self.window) + i0) * DT
        osl = slice(i0, i0 + self.window)
        t0 = time.perf_counter()
        for r in range(2):
            dw, cw = self.window_at(r, w0)
            with self.clients[r].lock:
                # resync first: the solve thread rebinds client.state on
                # pose pushes and forwarded closures
                self.mappers[r].state = self.clients[r].state
                self.mappers[r].step_batch(dw, cw, self.odom[r][osl], ts)
                self.clients[r].state = self.mappers[r].state
        self.counts["windows"] += 1
        self.stage["integrate"] += time.perf_counter() - t0
        # deferred local solves of forwarded closures; their pose deltas
        # are not published to the server (its chains stay raw odometry)
        t0 = time.perf_counter()
        self._local_pgo()
        self.stage["local_pgo"] += time.perf_counter() - t0
        if not self.no_loops:
            for k in range(w0, w0 + self.window, KF_STRIDE):
                for r in range(2):
                    self.kf_jobs.put((r, k, (lap * self.n_lap + k) * DT))

    def _local_pgo(self) -> None:
        for c, m in zip(self.clients, self.mappers):
            with c.lock:
                if c.run_pending_local_pgo():
                    m.state = c.state

    def stream(self, log=print) -> None:
        """Every lap, window by window (``paced``: each window released at
        its sensor time), then a live-mesh request a lap."""
        self.t_start = time.perf_counter()
        for lap in range(self.laps):
            for w0 in range(0, self.n_lap, self.window):
                if self.paced:
                    # the window's frames finish capturing at sensor time
                    # (i0 + window)·DT; a positive lag means the pipeline
                    # fell behind the sensor
                    i0 = lap * self.n_lap + w0
                    lag = (time.perf_counter() - self.t_start
                           - (i0 + self.window) * DT)
                    if lag < 0:
                        time.sleep(-lag)
                    else:
                        self.max_window_lag = max(self.max_window_lag, lag)
                self.kf_queue_max = max(self.kf_queue_max,
                                        self.kf_jobs.qsize())
                self.stream_window(lap, w0)
            self.serve_jobs.put(True)
            if log is not None:
                log(f"lap {lap + 1}/{self.laps}: fused "
                    f"{self.counts['fused']}, kf queue "
                    f"{self.kf_jobs.qsize()}, server submaps "
                    f"{len(self.server.submaps)}, coalesced solves "
                    f"{self.server.coalesced_solves}")
        self.stream_wall = time.perf_counter() - self.t_start

    def drain(self) -> bool:
        """The detector and serving threads finish their queued tails and
        are joined, then the last solve lands and the last local solves
        run → whether every thread joined."""
        t0 = time.perf_counter()
        self.kf_jobs.put(None)
        self.serve_jobs.put(None)
        for t in self.threads:
            t.join(JOIN_TIMEOUT)
        joined = not any(t.is_alive() for t in self.threads)
        self.server.process_mf_future()
        self.server.wait_for_optimize()
        self._local_pgo()
        self.drain_wall = time.perf_counter() - t0
        self.pipeline_wall = time.perf_counter() - self.t_start
        return joined

    # -- the mission's end ---------------------------------------------------

    def finish(self, threads_joined: bool) -> dict:
        """finish_map on both robots, one more offline solve, the final
        global mesh, ATE per robot, the wire stage on the first four
        server submaps → the script's JSON (plus ``device``, the lock
        wait, the mapper's windows and frames, ``threads_joined``)."""
        server = self.server
        solve_wall = sum(f.get("solve_wall", 0.0) for f in server.fusion_log)
        for c, m in zip(self.clients, self.mappers):
            with c.lock:
                m.state = c.state      # pick up the server's pushes
                m.finish_map()
                c.state = m.state
        # a second pass lets the poses settle against the client-frame
        # alignment solved after the pose solve
        if server.in_control and len(server.submaps) >= 2:
            server.optimize()
        _fence(self.device)
        t_mesh = time.perf_counter()
        _, verts, _ = server.get_final_global_mesh(
            os.path.join(self.work_dir, "final.ply"), isolate=False,
            mesh_spec=self.mesh_spec)
        _fence(self.device)
        mesh_wall = time.perf_counter() - t_mesh
        sdf = np.abs(syn.scene_sdf(self.scene, upload(np.ascontiguousarray(
            verts.reshape(-1, 3)), self.device)).cpu().numpy())

        ates = []
        gt_stamps = np.arange(self.n_frames) * DT
        for r in range(2):
            stamps, poses = server.pose_history(r)
            order = np.argsort(stamps)
            ates.append(float(metrics.ate_rmse(
                stamps[order], poses[order], gt_stamps, self.gt[r],
                align=False)))

        art = {
            "frames": 2 * self.n_frames,
            "sensor_rate_fps": 2.0 / DT,
            "pipeline_wall_s": round(self.pipeline_wall, 2),
            "pipeline_fps": round(2 * self.n_frames / self.pipeline_wall, 2),
            "stream_wall_s": round(self.stream_wall, 2),
            "stream_fps": round(2 * self.n_frames / self.stream_wall, 2),
            "paced": bool(self.paced),
            "kf_queue_max": self.kf_queue_max,
            "max_window_lag_s": round(self.max_window_lag, 3),
            "realtime_factor": round(
                (2 * self.n_frames / self.pipeline_wall) / (2.0 / DT), 2),
            "stage_wall_s": {k: round(v, 2) for k, v in self.stage.items()},
            "drain_wall_s": round(self.drain_wall, 2),
            "async_solve_wall_s": round(solve_wall, 2),
            "n_solves": len(server.fusion_log),
            "coalesced_solves": server.coalesced_solves,
            "keyframes": self.counts["kf"],
            "detect_ms_per_keyframe": round(
                1e3 * self.stage["detect"] / max(self.counts["kf"], 1), 1),
            "fusion_candidates": self.counts["cand"],
            "fusions_accepted": self.counts["fused"],
            "server_submaps": len(server.submaps),
            "ate_m": [round(a, 4) for a in ates],
        }
        sat = [m.union_saturation() for m in self.mappers]
        art.update({
            "union_watermark": [s[0] for s in sat],
            "dropped_union_blocks": [s[1] for s in sat],
            "dropped_submap_rollovers": [m.dropped_submaps
                                         for m in self.mappers],
            "server_dropped_constraints": int(
                server.constraints.num_dropped()),
            "dropped_keyframes": self.detector.dropped_keyframes,
            "live_mesh_updates": self.serve_counts["updates"],
            "live_chunks_remeshed": sum(
                ms.chunks_remeshed for m in self.mappers
                for ms in m._meshers.values()),
            "final_mesh_tris": int(verts.shape[0]),
            "final_mesh_wall_s": round(mesh_wall, 2),
            "surface_err_p90_m": (round(float(np.quantile(sdf, 0.9)), 4)
                                  if sdf.size else math.inf),
            "backend": self.device.type,
            "device": (runtime.gpu_identity() if self.device.type == "cuda"
                       else "cpu"),
            "optimize_errors": list(server.optimize_errors) + self.errors,
            "wire_bandwidth": self._wire_stage(),
            "mapper_windows": [self.counts["windows"]] * len(self.mappers),
            "integrated_frames": [int(c.state.frame_count)
                                  for c in self.clients],
            "threads_joined": threads_joined,
        })
        return art

    def _wire_stage(self) -> dict:
        """Voxel-wire vs mesh-wire bytes and latency per submap on the
        mission's own first four server submaps (eval_data_publisher.h:
        23-31, msg_converter.h:149-167)."""
        server, spec = self.server, self.cfg.spec
        bw = wire.BandwidthLog()
        rows = []
        n_bw = min(4, len(server.submaps))
        for s in server.submaps[:n_bw]:
            t0 = time.perf_counter()
            msg = wire.pack_submap_msg(
                spec, s.client_id, s.client_submap_id, s.layer,
                s.T_cli_submap, s.start_time, s.end_time,
                s.hist_stamps, s.hist_poses)
            bw.record(f"submap_{s.sid}_voxel", len(msg), t0)
            voxel_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            m = mesh_comm.encode_submap_mesh(
                spec, s.layer, s.hist_stamps, s.hist_poses,
                self.cfg.intrinsics, client_id=s.client_id,
                submap_id=s.client_submap_id)
            bw.record(f"submap_{s.sid}_mesh", m.nbytes, t0)
            rows.append((len(msg), m.nbytes, voxel_s,
                         time.perf_counter() - t0))
        if not rows:
            return {}
        vb = [x[0] for x in rows]
        mb = [x[1] for x in rows]
        return {
            "submaps_measured": n_bw,
            "voxel_wire_bytes_per_submap": int(np.mean(vb)),
            "mesh_wire_bytes_per_submap": int(np.mean(mb)),
            "mesh_vs_voxel_ratio": round(float(np.sum(mb) / np.sum(vb)), 4),
            "voxel_wire_s_per_transfer": round(
                float(np.mean([x[2] for x in rows])), 3),
            "mesh_wire_s_per_transfer": round(
                float(np.mean([x[3] for x in rows])), 3),
            "voxel_size_m": spec.voxel_size,
            "submap_interval_s": self.cfg.submap_interval,
        }

    def run(self, log=print) -> dict:
        """The whole mission → its JSON with ``gates`` and ``ok``. If the
        stream fails, the threads are still drained and joined."""
        self.start()
        try:
            self.stream(log)
        finally:
            joined = self.drain()
        art = self.finish(joined)
        art["gates"] = mission_gates(art, self.cfg.spec.voxel_size)
        art["ok"] = all(art["gates"].values())
        return art

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()


def endurance_run(device=None, laps: int = 6, paced: bool = False,
                  no_loops: bool = False, scale: float = 0.25,
                  out: Optional[str] = DEFAULT_OUT, log=print,
                  **mission_kw) -> dict:
    """The endurance mission on ``device`` (None: the card) → its JSON
    (the keys of tools/endurance_run.py's, ``stage_wall_s`` with
    ``live_mesh_lock_wait``, ``device``, ``gates`` and ``ok``), also
    written as one line to ``out`` unless it is None. ``mission_kw`` go
    to ``EnduranceMission`` (``n_lap``, ``window``, ``configs``,
    ``work_dir``)."""
    mission = EnduranceMission(device, laps, paced, no_loops, scale,
                               **mission_kw)
    try:
        art = mission.run(log)
    finally:
        mission.close()
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(json.dumps(art) + "\n")
    return art
