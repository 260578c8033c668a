"""Fusion server — port of ``coxgraph_tpu.server.fusion_server``, the
collaborative coordinator (CoxgraphServer with ClientHandler, the server
SubmapCollection, GlobalTfController, ClientTfOptimizer and the
DistributionController; reference coxgraph_server.{h,cpp}).

Host-orchestrated control around device solves: map-fusion messages gate
through the refuse / future-queue state machine, submaps are pulled from
clients on demand and kept once (send-once), the global pose graph runs
the two-phase dense-registration solve (``global_opt``), and client map
frames are aligned by a 4-DoF yaw-only solve (ClientTfOptimizer,
backend/node_collection.h:21-25).

The control plane is host numpy: submap poses, the client-frame
alignments and the constraint and height-prior pools. The pools live on
the host (``HostPool``), are written there by ``_add_constraint`` /
``_add_height``, and go to the device once per solve, so a fusion does
no device work and no device read, and a snapshot is a host copy. The
device holds the submap layers (copies served by the clients), the
registration caches and the solves.

Threads: with ``async_pgo`` the solve runs on a Python thread while the
robots integrate on others. Every thread enqueues on the device's one
default stream, so the clients' pause locks order the device work as
they order the host calls.

Client-pushed submap meshes (``comm.mesh_comm.MeshWithHistory``) are
cached by ``add_submap_mesh`` and combined in the global frame by
``combined_submap_mesh``.

With ``device_mesh`` the final global mesh's merge and meshing run over
the ranks of a process group (``parallel.merge_sharded``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..eval import export
from ..ops import merge as merge_ops
from ..ops import mesh as mesh_ops
from ..ops import mesh_post
from ..ops import registration as reg
from ..solver import pose_graph as pg
from ..utils.tensorops import host, upload
from . import global_opt
from .client_interface import InProcessClient, SubmapHandle

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """The JAX package's fields and defaults. Reference operating points:
    refuse_interval 20 s (server.yaml:15), ≤ 4 future retries
    (kMaxFutureUncatchedN, coxgraph_server.h:288), the client cap
    (coxgraph_server.h:285).

    ``refine_fusion_with_icp``: pre-refine a fusion's measurement by
    pairwise registration (off: dense registration enters the global
    solve as phase-2 residuals). ``intra_refuse_interval`` > 0 rate-limits
    same-client closures per client. ``reject_bad_candidates`` turns the
    dense candidate check (warn-only in the reference) into a gate.
    ``merge_pool_growth_cap``: the final-mesh merge pool grows to the next
    power of two above the summed live blocks, up to this multiple of
    ``spec.max_blocks`` (0: no growth). ``height_prior_stddev`` > 0 adds
    one absolute height prior per submap. ``async_pgo`` runs the solve on
    a background thread; ``nonblocking_pgo`` lets fusions land during a
    solve and coalesces them into one re-run; ``min_solve_interval``
    spaces solve starts; ``max_registration_pairs`` keeps the most
    overlapping pairs (0: all)."""

    spec: vx.VoxelGridSpec = vx.VoxelGridSpec()
    max_clients: int = 3
    max_submaps: int = 64
    max_constraints: int = 512
    refuse_interval: float = 20.0
    max_future_retries: int = 4
    odom_sqrt_info: float = 20.0
    fusion_sqrt_info: float = 10.0
    registration: reg.RegistrationConfig = reg.RegistrationConfig()
    solver: pg.SolverConfig = pg.SolverConfig()
    refine_fusion_with_icp: bool = False
    icp_max_correction: float = 0.15
    registration_weight: float = 30.0
    intra_refuse_interval: float = 0.0
    verbose: bool = False
    reject_bad_candidates: bool = False
    merge_pool_growth_cap: int = 4
    candidate_max_rms: float = 0.75    # voxels, surface-agreement gate
    candidate_min_inliers: int = 30
    publish_global_mesh_on_update: bool = False
    mesh_updates_per_client: int = 4
    height_prior_stddev: float = 0.0
    async_pgo: bool = False
    nonblocking_pgo: bool = False
    min_solve_interval: float = 0.0
    max_registration_pairs: int = 0


def average_same_stamp(stamps: np.ndarray, poses: np.ndarray,
                       decimals: int = 6):
    """Average poses sharing a (rounded) timestamp: translations by mean,
    quaternions componentwise after sign-aligning to the first member,
    then renormalized (kindr interpolateComponentwise,
    submap_collection.h:95-144). Returns stamps sorted ascending."""
    stamps = np.asarray(stamps)
    poses = np.asarray(poses)
    key = stamps.round(decimals)
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    out = np.zeros((uniq.shape[0], 7))
    # sign-align every quat to its group's first occurrence
    first = np.zeros(uniq.shape[0], np.int64)
    first[inv[::-1]] = np.arange(len(inv))[::-1]
    ref_q = poses[first][inv, :4]
    sign = np.where(np.sum(poses[:, :4] * ref_q, axis=1) < 0, -1.0, 1.0)
    q = poses[:, :4] * sign[:, None]
    for c in range(4):
        out[:, c] = np.bincount(inv, weights=q[:, c],
                                minlength=uniq.shape[0])
    for c in range(3):
        out[:, 4 + c] = np.bincount(inv, weights=poses[:, 4 + c],
                                    minlength=uniq.shape[0])
    out /= counts[:, None]
    out[:, :4] /= np.maximum(
        np.linalg.norm(out[:, :4], axis=1, keepdims=True), 1e-12)
    return uniq, out


@dataclasses.dataclass
class MapFusionMsg:
    """Inter-robot loop closure (coxgraph_msgs/MapFusion.msg:1-6):
    ``T_from_to`` (7,) maps the new frame's camera (``to``) into the stored
    keyframe's camera (``from``); ``sqrt_info`` is the 6×6 measurement
    weight or None. Host numpy arrays."""

    from_client: int
    from_time: float
    to_client: int
    to_time: float
    T_from_to: np.ndarray
    sqrt_info: Optional[np.ndarray] = None


@dataclasses.dataclass
class ServerSubmap:
    """One collected submap. Poses are host numpy (7,) [q, t]; the layer
    is the server's own copy."""

    sid: int
    client_id: int
    client_submap_id: int
    layer: vx.TsdfLayer
    T_cli_submap: np.ndarray   # original client-odom pose (chain constraints)
    T_G_submap: np.ndarray     # optimized global pose (the PGO variable)
    start_time: float
    end_time: float
    hist_stamps: np.ndarray
    hist_poses: np.ndarray
    # (pts, sdf, mask) registration-point cache for this layer version;
    # invalidated on refresh
    reg_cache: Optional[tuple] = None
    # layer version (bumped on refresh): guards a nonblocking solve's
    # cache write-back computed against an older layer
    version: int = 0
    # host-cached geometry, computed once per version (_ensure_geometry)
    n_blocks: int = 0
    aabb: Optional[np.ndarray] = None     # (2,3) submap-frame [min; max]


class HostPool:
    """Host mirror of one of the solver's fixed-capacity pools
    (``pg.RelPoseConstraints`` or ``pg.HeightConstraints``): the same
    fields as numpy arrays, rows appended on the host and the whole pool
    moved to a device by ``on``. ``count`` is the insertion watermark."""

    def __init__(self, cls, capacity: int):
        self.cls = cls
        empty = cls.empty(capacity, torch.device("cpu"))
        self.fields = {f.name: getattr(empty, f.name).numpy().copy()
                       for f in dataclasses.fields(cls) if f.name != "count"}
        self.count = 0

    @property
    def capacity(self) -> int:
        return len(self.fields["valid"])

    def add(self, **row) -> None:
        k = self.count
        if k < self.capacity:
            for name, val in row.items():
                self.fields[name][k] = val
            self.fields["valid"][k] = True
        self.count = k + 1

    def copy(self) -> "HostPool":
        out = HostPool.__new__(HostPool)
        out.cls = self.cls
        out.fields = {k: v.copy() for k, v in self.fields.items()}
        out.count = self.count
        return out

    def on(self, device):
        """The pool as the solver's dataclass on ``device`` (one
        non-blocking upload per field)."""
        return self.cls(count=torch.full((), self.count, dtype=torch.int32,
                                         device=device),
                        **{k: upload(v, device)
                           for k, v in self.fields.items()})


class CoxgraphServer:
    """``device`` holds the server's solves and merged maps; None means
    the card (``runtime.require_cuda()``). The clients' states must live
    on the same device."""

    def __init__(self, cfg: ServerConfig, clients: List[InProcessClient],
                 device=None):
        if len(clients) > cfg.max_clients:
            raise ValueError(f"{len(clients)} clients > max_clients "
                             f"{cfg.max_clients}")
        self.cfg = cfg
        self.device = (runtime.require_cuda() if device is None
                       else torch.device(device))
        self.clients: Dict[int, InProcessClient] = {
            c.client_id: c for c in clients}
        self.submaps: List[ServerSubmap] = []
        self.cli_ser: Dict[Tuple[int, int], int] = {}
        self._cons = HostPool(pg.RelPoseConstraints, cfg.max_constraints)
        # absolute height priors, one per submap when enabled
        self._heights = HostPool(pg.HeightConstraints, cfg.max_submaps)
        # constraint type tags in insertion order ("submap_rp" = chain,
        # "fusion" = inter-robot loop), for residuals by type
        # (evaluateResiduals, coxgraph_server.cpp:541-554)
        self.constraint_kinds: List[str] = []
        self.T_G_cli: Dict[int, np.ndarray] = {
            c.client_id: geo.identity_np() for c in clients}
        self.fused: Dict[int, bool] = {c.client_id: c.client_id ==
                                       clients[0].client_id
                                       for c in clients}
        self.last_fusion_time: Dict[Tuple[int, int], float] = {}
        self.future_queue: List[Tuple[MapFusionMsg, int]] = []
        self.in_control = True          # DistributionController
        self.fusion_log: List[dict] = []
        self.candidate_log: List[dict] = []   # checkLoopClosureCandidates
        # client-pushed submap meshes, (cid, csid) → MeshWithHistory
        # (MeshCollection, mesh_collection.h:25-31)
        self.mesh_collection: Dict[Tuple[int, int], object] = {}
        # auto-mesh bookkeeping (coxgraph_server.h:109, :183)
        self.global_mesh_need_update = 0
        self.global_mesh_initialized = False
        # async PGO (optimize_thread_ + the wait-for-previous gate,
        # coxgraph_server.cpp:417-428); _state_lock plays the reference's
        # submap_add_/map_fuse_ mutexes (coxgraph_server.h:244-255)
        self._opt_thread: Optional[threading.Thread] = None
        self._state_lock = threading.RLock()
        # nonblocking kick state: _kick_lock guards (thread, pending); a
        # kick while a solve runs sets pending and the thread loops again
        self._kick_lock = threading.Lock()
        self._solve_pending = False
        self.coalesced_solves = 0
        self.optimize_errors: List[str] = []
        # fusion ↔ final-mesh exclusion (final_mesh_gen_mutex_,
        # coxgraph_server.h:267); also guards future_queue
        self._fusion_lock = threading.RLock()
        # saturation accounting: fixed pools drop on overflow, observably
        self.dropped_constraints = 0
        self.dropped_heights = 0
        self.dropped_submaps = 0
        # node_evaluator ["cpu","mem"] (evaluation_config.yaml:1-2)
        self._resources = runtime.ResourceSampler()
        # stacked-field cache of the phase-2 solve (valid across solves
        # under the send-once discipline)
        self._reg_stack_cache: dict = {}
        # deferred candidate checks, run just before the next solve (the
        # reference's placement, coxgraph_server.cpp:509-512), so the
        # fusion path reads nothing from the device
        self._pending_checks: List[Tuple[int, int, np.ndarray]] = []

    # ------------------------------------------------------------------
    # Pools (host mirrors, see the module docstring)
    # ------------------------------------------------------------------

    @property
    def constraints(self) -> pg.RelPoseConstraints:
        """The relative-pose pool on the server's device (an upload)."""
        with self._state_lock:
            return self._cons.on(self.device)

    @property
    def heights(self) -> pg.HeightConstraints:
        """The height-prior pool on the server's device (an upload)."""
        with self._state_lock:
            return self._heights.on(self.device)

    # ------------------------------------------------------------------
    # Distribution controller (distribution_controller.h:49-87)
    # ------------------------------------------------------------------

    def control_trigger(self, in_control: bool) -> None:
        self.in_control = in_control

    def state_query(self) -> dict:
        with self._state_lock:
            self._ensure_geometry()
            boxes = [global_opt.transformed_aabb(s.aabb, s.T_G_submap)
                     for s in self.submaps]
            return {"n_submaps": len(self.submaps),
                    "aabbs": boxes,
                    "resources": self._resources.sample()}

    # ------------------------------------------------------------------
    # Fusion gating (needRefuse/needToFuse, coxgraph_server.cpp:372-394)
    # ------------------------------------------------------------------

    def global_frames(self, prefix: str = "mission"):
        """{(mission frame, client odom frame): T_G_cli} — the pull form of
        GlobalTfController's T_G_Client broadcast
        (global_tf_controller.cpp:40-46), gated on in_control."""
        if not self.in_control:
            return {}
        with self._state_lock:
            return {(f"{prefix}_g", f"client{cid}_odom"): T
                    for cid, T in self.T_G_cli.items()}

    def need_to_fuse(self, cid_a: int, cid_b: int, t: float) -> bool:
        key = (min(cid_a, cid_b), max(cid_a, cid_b))
        last = self.last_fusion_time.get(key)
        if last is None:
            return True
        return (t - last) >= self.cfg.refuse_interval

    # ------------------------------------------------------------------
    # Submap collection bookkeeping
    # ------------------------------------------------------------------

    def _add_constraint(self, i: int, j: int, T_meas, sqrt_info,
                        kind: str) -> bool:
        """Append to the constraint pool; past max_constraints the
        measurement is DROPPED with a warning and a count."""
        if len(self.constraint_kinds) >= self.cfg.max_constraints:
            self.dropped_constraints += 1
            warnings.warn(
                f"constraint pool saturated ({self.cfg.max_constraints}): "
                f"dropping {kind} measurement ({i},{j}) — "
                f"{self.dropped_constraints} dropped so far; raise "
                "ServerConfig.max_constraints", RuntimeWarning, stacklevel=3)
            return False
        with self._state_lock:
            # under the state lock so a solve's snapshot never sees the
            # (pool, kinds) pair mid-update
            self._cons.add(i=i, j=j, T_meas=host(T_meas),
                           sqrt_info=host(sqrt_info))
            self.constraint_kinds.append(kind)
        return True

    def _add_height(self, sid: int, z: float) -> None:
        """Height-prior append with the same saturation semantics."""
        if self._heights.count >= self._heights.capacity:
            self.dropped_heights += 1
            warnings.warn(
                f"height-prior pool saturated ({self._heights.capacity}): "
                f"dropping prior for submap {sid} — "
                f"{self.dropped_heights} dropped so far",
                RuntimeWarning, stacklevel=3)
            return
        with self._state_lock:
            self._heights.add(i=sid, height=z,
                              info=1.0 / self.cfg.height_prior_stddev)

    def _ensure_geometry(self) -> None:
        """Fill the missing version-cached geometry (block count and
        submap-frame AABB) of all submaps in ONE device read."""
        with self._state_lock:
            missing = [s for s in self.submaps if s.aabb is None]
            if not missing:
                return
            aabbs, counts = global_opt.submap_geometry(
                self.cfg.spec, [s.layer for s in missing])
        for s, box, n in zip(missing, aabbs, counts):
            s.n_blocks, s.aabb = n, box

    def _add_submap(self, h: SubmapHandle) -> Optional[int]:
        with self._state_lock:
            return self._add_submap_locked(h)

    def _acquire_submap(self, cid: int, t: float) -> Optional[int]:
        """Server submap covering client ``cid`` at time ``t``: served from
        the collection when a stored interval covers t (send-once: a
        finished submap never changes), else pulled from the client."""
        with self._state_lock:
            for s in self.submaps:
                if s.client_id == cid and \
                        s.start_time - 1e-6 <= t <= s.end_time + 1e-6:
                    return s.sid
        h = self.clients[cid].get_submap_by_time(t)
        if h is None:
            return None
        return self._add_submap(h)

    def _pose_in_submap(self, sid: int, t: float) -> Optional[np.ndarray]:
        """T_submap_cam at ``t`` from the stored history when it covers t
        (host math), else through the client's lookup service."""
        s = self.submaps[sid]
        hs = np.asarray(s.hist_stamps)
        if hs.size and hs[0] - 1e-6 <= t <= hs[-1] + 1e-6:
            return geo.lookup_pose_np(hs, np.asarray(s.hist_poses), t)
        out = self.clients[s.client_id].lookup_pose_in_submap(
            s.client_submap_id, t)
        return None if out is None else np.asarray(out)

    def _add_submap_locked(self, h: SubmapHandle) -> Optional[int]:
        """→ server submap id, or None when the pool is saturated
        (warn-and-reject; the server keeps serving)."""
        key = (h.client_id, h.client_submap_id)
        if key in self.cli_ser:
            sid = self.cli_ser[key]
            old = self.submaps[sid]
            if h.end_time <= old.end_time + 1e-9:
                # nothing new integrated since the last pull: keep the
                # stored layer and its cached geometry and points
                return sid
            # refresh layer + history; keep both poses; the version bump
            # invalidates the caches and guards in-flight write-backs
            self.submaps[sid] = ServerSubmap(
                sid=sid, client_id=h.client_id,
                client_submap_id=h.client_submap_id, layer=h.layer,
                T_cli_submap=old.T_cli_submap,
                T_G_submap=old.T_G_submap,
                start_time=h.start_time, end_time=h.end_time,
                hist_stamps=h.hist_stamps, hist_poses=h.hist_poses,
                version=old.version + 1)
            return sid
        sid = len(self.submaps)
        if sid >= self.cfg.max_submaps:
            # warn-and-reject (the reference's collection grows,
            # submap_collection.cpp:10-22; here the ceiling is explicit)
            self.dropped_submaps += 1
            warnings.warn(
                f"server submap pool saturated ({self.cfg.max_submaps}): "
                f"rejecting submap (client {h.client_id}, csid "
                f"{h.client_submap_id}) — {self.dropped_submaps} dropped "
                "so far; raise ServerConfig.max_submaps",
                RuntimeWarning, stacklevel=3)
            return None
        T_cli = np.asarray(h.T_cli_submap, np.float32)
        self.submaps.append(ServerSubmap(
            sid=sid, client_id=h.client_id,
            client_submap_id=h.client_submap_id, layer=h.layer,
            T_cli_submap=T_cli,
            T_G_submap=geo.compose_np(self.T_G_cli[h.client_id], T_cli),
            start_time=h.start_time, end_time=h.end_time,
            hist_stamps=h.hist_stamps, hist_poses=h.hist_poses))
        self.cli_ser[key] = sid
        if self.cfg.height_prior_stddev > 0:
            # odom z as an absolute height (gravity-aligned VIO frame)
            self._add_height(sid, float(T_cli[6]))
        # chain constraint to the previous submap of the same client
        # (updateSubmapRPConstraints, pose_graph_interface.cpp:51-71)
        prev = self.cli_ser.get((h.client_id, h.client_submap_id - 1))
        if prev is not None:
            T_prev_new = geo.relative_np(self.submaps[prev].T_cli_submap,
                                         T_cli)
            self._add_constraint(prev, sid, T_prev_new,
                                 self.cfg.odom_sqrt_info * np.eye(6),
                                 "submap_rp")
        return sid

    def add_submap_mesh(self, cid: int, csid: int, mesh_msg) -> None:
        """Cache a client-pushed submap mesh (ClientHandler::
        submapMeshCallback → MeshCollection::addSubmapMesh,
        client_handler.h:185-193, mesh_collection.h:25-31)."""
        self.mesh_collection[(int(cid), int(csid))] = mesh_msg

    def publish_submap_meshes(self):
        """All cached client-pushed submap meshes, keyed (cid, csid): the
        pull form of ServerVisualizer::publishSubmapMeshes' republish
        timer (server_visualizer.h:194-203)."""
        return dict(self.mesh_collection)

    # flat per-client palette (msg_converter.h:239-257 getColor mode 1:
    # cid 0/1/2 → R/G/B), cycled past 3 clients
    _CLIENT_COLORS = np.array(
        [[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)

    def combined_submap_mesh(self, color_mode: int = 0,
                             ply_path: Optional[str] = None):
        """The client-pushed submap meshes combined in the current global
        frame (ServerVisualizer's mesh combination,
        server_visualizer.cpp:67-121, on o3dMeshFromMsg,
        msg_converter.h:202-264). color_mode 0 keeps the meshes' RGB, 1
        paints each client a flat colour. A mesh whose submap has not
        reached the collection yet is skipped (no pose). Host numpy →
        (vertices (V,3) f32, faces (F,3) u32, colors (V,3) u8)."""
        verts, faces, cols = [], [], []
        base = 0
        with self._state_lock:
            snapshot = [(cid, m, np.asarray(
                self.submaps[self.cli_ser[(cid, csid)]].T_G_submap,
                np.float32))
                for (cid, csid), m in sorted(self.mesh_collection.items())
                if (cid, csid) in self.cli_ser]
        for cid, m, T in snapshot:
            v = geo.transform_points_np(T, m.vertices())
            verts.append(v)
            faces.append(np.asarray(m.faces, np.uint32) + base)
            base += v.shape[0]
            if color_mode == 1:
                cols.append(np.broadcast_to(
                    self._CLIENT_COLORS[cid % 3], (v.shape[0], 3)).copy())
            else:
                cols.append(np.asarray(m.vcolors, np.uint8))
        if not verts:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.uint32), np.zeros((0, 3), np.uint8))
        V = np.concatenate(verts).astype(np.float32)
        F = np.concatenate(faces).astype(np.uint32)
        C = np.concatenate(cols).astype(np.uint8)
        if ply_path:
            export.write_ply_indexed(ply_path, V, F, C)
        return V, F, C

    def client_pose_updates(self, cid: int, updates) -> None:
        """Client local-PGO pose push: update the stored client-odom pose
        (current and 'original', as setPose + updateOriPose do,
        client_handler.cpp:106-129), keep the global pose consistent, and
        rebuild the chain constraints."""
        with self._state_lock:
            changed = False
            for csid, T in updates:
                sid = self.cli_ser.get((cid, int(csid)))
                if sid is None:
                    continue
                s = self.submaps[sid]
                s.T_cli_submap = np.asarray(host(T), np.float32)
                s.T_G_submap = geo.compose_np(self.T_G_cli[cid],
                                              s.T_cli_submap)
                changed = True
            if changed:
                self.update_submap_rp_constraints()

    def update_submap_rp_constraints(self) -> None:
        """Recompute the chain measurements from the current client-odom
        submap poses (updateSubmapRPConstraints, rebuilt before every
        fusion solve, pose_graph_interface.cpp:51-71)."""
        with self._state_lock:
            f = self._cons.fields
            for m, kind in enumerate(self.constraint_kinds):
                if kind != "submap_rp":
                    continue
                a, b = int(f["i"][m]), int(f["j"][m])
                f["T_meas"][m] = geo.relative_np(
                    self.submaps[a].T_cli_submap,
                    self.submaps[b].T_cli_submap)

    def _poses_np(self) -> np.ndarray:
        """Global submap poses (max_submaps, 7) f32, identity-padded."""
        out = np.tile(geo.identity_np(), (self.cfg.max_submaps, 1))
        for s in self.submaps:
            out[s.sid] = s.T_G_submap
        return out

    def _poses(self) -> Tensor:
        """Global submap poses on the device (padded to max_submaps)."""
        return upload(self._poses_np(), self.device)

    # ------------------------------------------------------------------
    # Timeline / future-fusion machinery (coxgraph_server.cpp:328-366)
    # ------------------------------------------------------------------

    def time_line_update(self) -> None:
        """Retry queued 'future' fusions after clients advanced and count
        the update toward the periodic auto-mesh
        (timeLineUpdateCallback, coxgraph_server.h:181-184)."""
        with self._state_lock:
            self.global_mesh_need_update += 1
        self.process_mf_future()

    def process_mf_future(self) -> None:
        """Drain the queued 'future' fusions (processMFFuture,
        coxgraph_server.cpp:328-366) under _fusion_lock: retries mutate the
        graph as map_fusion does, so they honour the final-mesh window."""
        if not self.future_queue:
            # unlocked fast path for the per-frame tick; a retry queued
            # this instant is taken on the next tick
            return
        with self._fusion_lock:
            if not self.future_queue:
                return
            queue, self.future_queue = self.future_queue, []
            for mf, tries in queue:
                ok = self._try_fuse(mf)
                if not ok and tries + 1 < self.cfg.max_future_retries:
                    self.future_queue.append((mf, tries + 1))

    def generate_global_mesh_event(self, **mesh_kwargs):
        """Poll form of the 1 Hz auto-mesh timer (generateGlobalMeshEvent,
        coxgraph_server.h:275-283): once a first global mesh exists,
        regenerate after mesh_updates_per_client timeline updates per
        client → (merged, verts, cols) or None."""
        if (not self.cfg.publish_global_mesh_on_update
                or not self.global_mesh_initialized
                or self.global_mesh_need_update // max(1, len(self.clients))
                < self.cfg.mesh_updates_per_client):
            return None
        return self.get_final_global_mesh(None, **mesh_kwargs)

    # ------------------------------------------------------------------
    # Map fusion (mapFusionCallback + fuseMap, coxgraph_server.cpp:198-476)
    # ------------------------------------------------------------------

    def map_fusion(self, mf: MapFusionMsg) -> bool:
        if mf.from_client == mf.to_client:
            # intra-client → forwarded back as a loop closure (:217-222)
            key = (mf.from_client, mf.from_client)
            if self.cfg.intra_refuse_interval > 0:
                last = self.last_fusion_time.get(key)
                if last is not None and \
                        mf.to_time - last < self.cfg.intra_refuse_interval:
                    return False
            ok = self.clients[mf.from_client].receive_loop_closure(
                mf.from_time, mf.to_time, mf.T_from_to, mf.sqrt_info)
            if ok:
                self.last_fusion_time[key] = max(mf.from_time, mf.to_time)
            return ok
        if not self.need_to_fuse(mf.from_client, mf.to_client, mf.to_time):
            return False
        with self._fusion_lock:
            ok = self._try_fuse(mf)
            if not ok:
                self.future_queue.append((mf, 0))
        return ok

    # ------------------------------------------------------------------
    # Async PGO (std::async(optimizePoseGraph), coxgraph_server.cpp:471-473)
    # ------------------------------------------------------------------

    def wait_for_optimize(self) -> None:
        """Block until background solves (and any pending re-run) finish
        — the wait-for-previous gate (coxgraph_server.cpp:417-428)."""
        while True:
            with self._kick_lock:
                t = self._opt_thread
            if t is None or t is threading.current_thread():
                return
            t.join()

    def _optimize_guarded(self) -> None:
        try:
            self.optimize()
        except Exception as e:  # noqa: BLE001 — a solve failure must not
            # kill the server; it is reported through optimize_errors
            self.optimize_errors.append(f"{type(e).__name__}: {e}")

    def _opt_loop(self) -> None:
        """Solve-thread body: run, then re-run while fusions marked the
        graph dirty mid-solve. The thread unregisters itself inside
        _kick_lock, so a racing kick either sees it alive or starts a new
        one."""
        while True:
            t0 = time.monotonic()
            self._optimize_guarded()
            with self._kick_lock:
                if not self._solve_pending:
                    self._opt_thread = None
                    return
                self._solve_pending = False
            rem = self.cfg.min_solve_interval - (time.monotonic() - t0)
            if rem > 0:
                time.sleep(rem)

    def _kick_optimize(self) -> None:
        if not self.cfg.async_pgo:
            self.optimize()
            return
        if not self.cfg.nonblocking_pgo:
            self.wait_for_optimize()
        with self._kick_lock:
            if self._opt_thread is not None:
                self._solve_pending = True
                self.coalesced_solves += 1
                return
            self._solve_pending = False
            self._opt_thread = threading.Thread(target=self._opt_loop,
                                                daemon=True)
            self._opt_thread.start()

    def _try_fuse(self, mf: MapFusionMsg) -> bool:
        # the previous solve lands before the graph changes, unless
        # nonblocking (the solve holds a snapshot; write-backs guarded)
        if not self.cfg.nonblocking_pgo:
            self.wait_for_optimize()
        sa = self._acquire_submap(mf.from_client, mf.from_time)
        sb = self._acquire_submap(mf.to_client, mf.to_time)
        if sa is None or sb is None:
            # future, unreachable or pool-saturated: requeued by the caller
            return False
        # T_SA_SB = T_SA_ta · T_ta_tb · T_SB_tb⁻¹ (coxgraph_server.cpp:449-464)
        T_sa_ta = self._pose_in_submap(sa, mf.from_time)
        T_sb_tb = self._pose_in_submap(sb, mf.to_time)
        if T_sa_ta is None or T_sb_tb is None:
            return False
        T_sa_sb = geo.compose_np(
            geo.compose_np(T_sa_ta, host(mf.T_from_to)),
            geo.inverse_np(T_sb_tb))

        if self.cfg.refine_fusion_with_icp:
            T_dev = upload(np.asarray(T_sa_sb, np.float32), self.device)
            r = reg.register_pair(self.cfg.spec, self.submaps[sa].layer,
                                  self.submaps[sb].layer, T_dev,
                                  self.cfg.registration)
            corr = torch.linalg.norm(geo.se3_log(geo.relative(T_dev,
                                                              r.T_A_B)))
            vals = torch.cat([torch.stack([
                corr, r.n_inliers.to(corr.dtype), r.cost, r.initial_cost]),
                r.T_A_B]).cpu().numpy()
            if (int(vals[1]) > 50 and vals[2] <= vals[3]
                    and vals[0] < self.cfg.icp_max_correction):
                T_sa_sb = vals[4:]

        # dense candidate check (checkLoopClosureCandidates): warn-only
        # in the reference, so deferred to the next solve; a gate when
        # reject_bad_candidates
        if self.cfg.reject_bad_candidates:
            check = self._check_candidate(sa, sb, T_sa_sb)
            if not check["ok"]:
                return False
        else:
            with self._state_lock:
                self._pending_checks.append((sa, sb, T_sa_sb))

        si = (host(mf.sqrt_info) if mf.sqrt_info is not None
              else self.cfg.fusion_sqrt_info * np.eye(6))
        if not self._add_constraint(sa, sb, T_sa_sb, si, "fusion"):
            return False

        key = (min(mf.from_client, mf.to_client),
               max(mf.from_client, mf.to_client))
        self.last_fusion_time[key] = max(mf.from_time, mf.to_time)
        self.fused[mf.from_client] = True
        self.fused[mf.to_client] = True

        if self.in_control:
            self._kick_optimize()
        return True

    # ------------------------------------------------------------------
    # Global optimization + client-frame alignment
    # ------------------------------------------------------------------

    def _check_candidate(self, sa: int, sb: int, T_sa_sb) -> dict:
        """Dense-agreement check of one candidate, sharing submap A's
        registration-point cache with the solve; appended to
        candidate_log."""
        s_a = self.submaps[sa]
        if s_a.reg_cache is None:
            s_a.reg_cache = reg.surface_point_cache(
                self.cfg.spec, s_a.layer, self.cfg.registration)
        check = global_opt.check_loop_closure_candidates(
            self.cfg.spec, [s_a.layer, self.submaps[sb].layer],
            [(0, 1, T_sa_sb)], self.cfg.registration,
            max_rms=self.cfg.candidate_max_rms,
            min_inliers=self.cfg.candidate_min_inliers,
            caches=[s_a.reg_cache, None])[0]
        check["sa"], check["sb"] = sa, sb
        self.candidate_log.append(check)
        return check

    def _drain_pending_checks(self) -> None:
        with self._state_lock:
            pending, self._pending_checks = self._pending_checks, []
        for sa, sb, T in pending:
            self._check_candidate(sa, sb, T)

    def optimize(self, push_updates: bool = True) -> dict:
        """Two-phase global solve, then the client-frame 4-DoF alignment
        and the pose push-back (optimizePoseGraph +
        updateCliMapRelativePose, coxgraph_server.cpp:503-582).
        ``push_updates=False`` keeps the result on the server (the
        isolated final-mesh solve).

        The graph snapshot and the write-back run under _state_lock, the
        solve unlocked. The snapshot is host copies and uploads, so
        fusions landing mid-solve (nonblocking_pgo) cannot change it; the
        write-back covers the snapshot's submaps and keeps a cache only
        where the submap's version is unchanged. Device reads: the
        geometry of new submaps (one), the solve's own, the solution
        (one) and the client-frame solve (one)."""
        self._drain_pending_checks()
        self._ensure_geometry()
        with self._state_lock:
            n = len(self.submaps)
            if n < 2:
                return {}
            self.update_submap_rp_constraints()
            poses = self._poses()
            layers = [s.layer for s in self.submaps]
            constraints = self._cons.on(self.device)
            heights = (self._heights.on(self.device)
                       if self.cfg.height_prior_stddev > 0 else None)
            # same-client adjacent pairs are chained by odometry already
            skip = [(self.cli_ser[(c, k)], self.cli_ser[(c, k + 1)])
                    for (c, k) in list(self.cli_ser)
                    if (c, k + 1) in self.cli_ser]
            caches = [s.reg_cache for s in self.submaps]
            aabbs = [s.aabb for s in self.submaps]
            blocks = [s.n_blocks for s in self.submaps]
            versions = [s.version for s in self.submaps]
            # gauge: the first submap of the lowest-id client (the frame
            # ClientTfOptimizer holds constant, node_collection.h:21-25)
            ref_cid = min(s.client_id for s in self.submaps)
            anchor = next(s.sid for s in self.submaps
                          if s.client_id == ref_cid)
            fixed = np.zeros((self.cfg.max_submaps,), bool)
            fixed[anchor] = True
        t_solve = time.monotonic()
        new_poses, info = global_opt.optimize_two_phase(
            poses, constraints, self.cfg.spec, layers,
            reg_cfg=self.cfg.registration, solver_cfg=self.cfg.solver,
            registration_weight=self.cfg.registration_weight,
            skip_pairs=skip, reg_caches=caches,
            fixed=upload(fixed, self.device), heights=heights,
            submap_aabbs=aabbs, submap_blocks=blocks,
            max_pairs=self.cfg.max_registration_pairs,
            stack_cache=self._reg_stack_cache)
        new_poses_np = new_poses.cpu().numpy()    # ONE read of the solution
        info["solve_wall"] = time.monotonic() - t_solve
        with self._state_lock:
            for k, (c, v) in enumerate(zip(caches, versions)):
                s = self.submaps[k]
                if s.version == v:
                    s.reg_cache = c
            self._apply_global_poses(new_poses_np, n)
            self._align_client_frames(new_poses_np, n)
            if push_updates:
                self._push_pose_updates()
            if self.cfg.verbose:
                info["residuals"] = self.evaluate_residuals()
            self.fusion_log.append(info)
        return info

    def evaluate_residuals(self) -> Dict[str, list]:
        """Per-type whitened residual norms at the current global poses
        (evaluateResiduals, coxgraph_server.cpp:541-554)."""
        with self._state_lock:
            norms = global_opt.evaluate_residuals(self._poses(),
                                                  self.constraints)
            kinds = list(self.constraint_kinds)
        out: Dict[str, list] = {"fusion": [], "submap_rp": []}
        for k, kind in enumerate(kinds):
            out.setdefault(kind, []).append(float(norms[k]))
        return out

    def _apply_global_poses(self, poses_np: np.ndarray,
                            n: Optional[int] = None) -> None:
        """Solved poses onto the first ``n`` submaps (submaps added after
        the snapshot keep their T_G_cli-initialized pose)."""
        for s in self.submaps[:n]:
            s.T_G_submap = poses_np[s.sid]

    def _align_client_frames(self, poses_np: np.ndarray,
                             n_snapshot: Optional[int] = None) -> None:
        """4-DoF client-frame solve (ClientTfOptimizer): nodes = client
        frames, one measurement per valid cross-client constraint between
        submaps of the snapshot (coxgraph_server.cpp:556-582). The pool is
        assembled from the host pool and uploaded once."""
        cids = sorted(self.clients)
        cidx = {c: k for k, c in enumerate(cids)}
        M = self.cfg.max_constraints
        pool = HostPool(pg.RelPoseConstraints, M)
        f = self._cons.fields
        n_ok = (len(self.submaps) if n_snapshot is None
                else min(n_snapshot, len(self.submaps)))
        for m in np.flatnonzero(f["valid"]):
            a, b = int(f["i"][m]), int(f["j"][m])
            if a >= n_ok or b >= n_ok:
                continue
            sa, sb = self.submaps[a], self.submaps[b]
            if sa.client_id == sb.client_id:
                continue
            if pool.count >= M:
                break
            # T_CA_CB = T_CA_sma · (T_G_sma⁻¹ · T_G_smb) · T_CB_smb⁻¹
            T = geo.compose_np(
                geo.compose_np(sa.T_cli_submap,
                               geo.relative_np(poses_np[a], poses_np[b])),
                geo.inverse_np(sb.T_cli_submap))
            pool.add(i=cidx[sa.client_id], j=cidx[sb.client_id], T_meas=T)
        if pool.count == 0:
            return
        nodes = upload(np.stack([self.T_G_cli[c] for c in cids]
                                ).astype(np.float32), self.device)
        res = pg.optimize(nodes, pool.on(self.device),
                          pg.SolverConfig(iterations=10, yaw_only=True))
        solved = res.poses.cpu().numpy()          # ONE read
        for c in cids:
            self.T_G_cli[c] = solved[cidx[c]]

    def _push_pose_updates(self) -> None:
        """Optimized client-frame submap poses back to the clients
        (MapPoseUpdates, coxgraph_client.cpp:135-153 reversed)."""
        per_client: Dict[int, List] = {c: [] for c in self.clients}
        for s in self.submaps:
            T_cli_sm = geo.compose_np(
                geo.inverse_np(self.T_G_cli[s.client_id]), s.T_G_submap)
            per_client[s.client_id].append((s.client_submap_id, T_cli_sm))
        for c, updates in per_client.items():
            if updates:
                self.clients[c].apply_pose_updates(updates)

    # ------------------------------------------------------------------
    # Final global mesh + pose histories
    # ------------------------------------------------------------------

    def collect_all_submaps(self) -> None:
        for c in self.clients.values():
            if self.fused.get(c.client_id, False):
                for h in c.get_all_submaps():
                    self._add_submap(h)

    # graph snapshot/restore: the ServerVisualizer deep copy before the
    # final-mesh re-optimization (server_visualizer.cpp:28-31)

    def _snapshot_graph(self) -> dict:
        with self._state_lock:
            return {
                "submaps": [dataclasses.replace(s) for s in self.submaps],
                "cli_ser": dict(self.cli_ser),
                "constraints": self._cons.copy(),
                "constraint_kinds": list(self.constraint_kinds),
                "heights": self._heights.copy(),
                "T_G_cli": dict(self.T_G_cli),
                "fused": dict(self.fused),
            }

    def _restore_graph(self, snap: dict) -> None:
        with self._state_lock:
            self.submaps = snap["submaps"]
            self.cli_ser = snap["cli_ser"]
            self._cons = snap["constraints"]
            self.constraint_kinds = snap["constraint_kinds"]
            self._heights = snap["heights"]
            self.T_G_cli = snap["T_G_cli"]
            self.fused = snap["fused"]

    def _auto_merge_spec(self, spec: vx.VoxelGridSpec,
                         layers) -> vx.VoxelGridSpec:
        """A merge-target spec whose pool is the next power of two above
        the summed live blocks (an upper bound of the union), capped at
        merge_pool_growth_cap × the configured pool and the grid. One
        device read for all layers."""
        cap = self.cfg.merge_pool_growth_cap
        if cap <= 0 or not layers:
            return spec
        total = int(torch.stack([l.num_blocks for l in layers]).sum())
        if total <= spec.max_blocks:
            return spec
        need = 1 << (total - 1).bit_length()
        need = min(need, cap * spec.max_blocks, spec.grid_dim ** 3)
        if need <= spec.max_blocks:
            return spec
        return dataclasses.replace(spec, max_blocks=need)

    def get_final_global_mesh(self, ply_path: Optional[str] = None,
                              min_weight: float = 0.1,
                              mesh_spec: Optional[vx.VoxelGridSpec] = None,
                              device_mesh=None,
                              isolate: bool = True):
        """Drain pending fusions, pull every submap, re-optimize, merge in
        the global frame and mesh (ServerVisualizer::getFinalGlobalMesh,
        server_visualizer.cpp:20-142) → (merged layer, verts (T,3,3),
        colors (T,3,3)).

        ``isolate=True`` runs the collection and re-optimization on a copy
        of the graph and restores the online state afterwards
        (server_visualizer.cpp:28-31); fusions are locked out meanwhile
        (final_mesh_gen_mutex_, coxgraph_server.cpp:111-116).
        ``isolate=False`` keeps the re-optimized poses. With
        ``device_mesh`` (a ``parallel.collectives.RobotMesh``; every rank
        calls this on the same server state) the per-submap merge loop and
        the meshing run distributed: submaps and pool slots split over the
        ranks, one all_reduce per field fuses the pools
        (parallel.merge_sharded)."""
        with self._fusion_lock:
            self.wait_for_optimize()
            self.process_mf_future()
            snap = self._snapshot_graph() if isolate else None
            try:
                self.collect_all_submaps()
                self.global_mesh_initialized = True
                self.global_mesh_need_update = 0
                if self.in_control and len(self.submaps) >= 2:
                    self.optimize(push_updates=not isolate)
                merged, verts, cols = self._merge_and_mesh(
                    mesh_spec, min_weight, device_mesh)
            finally:
                if snap is not None:
                    self._restore_graph(snap)
        if ply_path:
            export.write_ply(ply_path, verts, cols)
        return merged, verts, cols

    def _merge_and_mesh(self, mesh_spec: Optional[vx.VoxelGridSpec],
                        min_weight: float, device_mesh=None):
        """Every submap merged at its current global pose into one layer,
        then meshed, over ``device_mesh``'s ranks when given → (merged,
        verts, cols)."""
        spec = mesh_spec or self.cfg.spec
        if mesh_spec is None:
            spec = self._auto_merge_spec(spec,
                                         [s.layer for s in self.submaps])
        poses = self._poses()
        # submaps stay at client resolution; the global mesh layer may be
        # finer or coarser (coxgraph_server.launch:5-6)
        src_spec = self.cfg.spec if spec != self.cfg.spec else None
        if device_mesh is not None and self.submaps:
            from ..parallel import merge_sharded as msh
            # every touched block of a submap in one pass, as the sized
            # sequential merge has it
            merged = msh.merge_layers_sharded(
                spec, device_mesh, [s.layer for s in self.submaps],
                [poses[s.sid] for s in self.submaps], src_spec=src_spec,
                max_touched=spec.max_blocks)
            verts, cols = msh.extract_mesh_sharded(
                spec, device_mesh, merged, min_weight=min_weight)
        else:
            merged = vx.create_tsdf_layer(spec, self.device)
            for s in self.submaps:
                merge_ops.merge_layer_into_sized(spec, merged, s.layer,
                                                 poses[s.sid],
                                                 src_spec=src_spec)
            verts, cols = mesh_ops.extract_mesh(spec, merged,
                                                min_weight=min_weight)
        if int(merged.num_blocks) >= spec.max_blocks:
            warnings.warn(
                "global-merge block pool saturated "
                f"({spec.max_blocks} blocks): the mesh may be truncated "
                "(surface blocks can lose allocation to far-field ones) — "
                "raise spec.max_blocks or pass a coarser mesh_spec",
                RuntimeWarning, stacklevel=3)
        return merged, verts, cols

    def merge_to_client_map(self, cid: int,
                            mesh_spec: Optional[vx.VoxelGridSpec] = None
                            ) -> vx.TsdfLayer:
        """Every server-held submap of client ``cid`` merged into ONE layer
        in that client's map frame (SubmapCollection::mergeToCliMap,
        submap_collection.cpp:24-37), at the optimized global poses
        pulled back through T_G_cli."""
        spec = mesh_spec or self.cfg.spec
        if mesh_spec is None:
            spec = self._auto_merge_spec(
                spec, [s.layer for s in self.submaps if s.client_id == cid])
        src_spec = self.cfg.spec if spec != self.cfg.spec else None
        merged = vx.create_tsdf_layer(spec, self.device)
        T_cli_G = geo.inverse_np(self.T_G_cli[cid])
        for s in self.submaps:
            if s.client_id != cid:
                continue
            T_cli_sm = geo.compose_np(T_cli_G, s.T_G_submap)
            merge_ops.merge_layer_into_sized(
                spec, merged, s.layer,
                upload(np.asarray(T_cli_sm, np.float32), self.device),
                src_spec=src_spec)
        return merged

    def get_final_global_mesh_postprocessed(
            self, ply_path: Optional[str] = None, min_weight: float = 0.1,
            mesh_spec: Optional[vx.VoxelGridSpec] = None,
            taubin_iterations: int = 100) -> mesh_post.IndexedMesh:
        """get_final_global_mesh + the reference's Open3D cleanup chain
        (merge close vertices → dedup → Taubin smooth → vertex-cluster
        simplify, server_visualizer.cpp:80-84), host numpy, exported as an
        indexed PLY."""
        spec = mesh_spec or self.cfg.spec
        _, verts, cols = self.get_final_global_mesh(
            None, min_weight=min_weight, mesh_spec=mesh_spec)
        clean = mesh_post.postprocess(
            verts, cols, merge_radius=1.2 * spec.voxel_size,
            taubin_iterations=taubin_iterations,
            simplify_voxel=spec.voxel_size)
        if ply_path:
            export.write_ply_indexed(ply_path, clean.vertices, clean.faces,
                                     clean.colors)
        return clean

    def save_pose_history(self, dir_path: str) -> str:
        """The FilePath get_pose_history service (getPoseHistoryCallback,
        coxgraph_server.cpp:143-187): every client's odom-frame trajectory
        through T_G_cli into one TUM file '<dir>/coxgraph_server_traj.txt'."""
        path = os.path.join(dir_path, "coxgraph_server_traj.txt")
        with open(path, "w") as f:
            for cid, c in self.clients.items():
                stamps, poses = c.get_pose_history()
                if len(stamps) == 0:
                    continue
                T = np.asarray(self.T_G_cli[cid], np.float32)
                for t, p in zip(stamps, geo.compose_np(T[None, :], poses)):
                    qw, qx, qy, qz, x, y, z = p
                    f.write(f"{t:.6f} {x:.7f} {y:.7f} {z:.7f} "
                            f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")
        return path

    def pose_history(self, client_id: int):
        """Global-frame trajectory of one client from its submap histories
        (stamps, poses) numpy; poses sharing a timestamp are averaged
        componentwise (kindr::interpolateComponentwise,
        submap_collection.h:95-144)."""
        stamps, poses = [], []
        with self._state_lock:
            snapshot = [(s.hist_stamps, np.asarray(s.hist_poses),
                         np.asarray(s.T_G_submap))
                        for s in self.submaps
                        if s.client_id == client_id
                        and len(s.hist_stamps) > 0]
        for hist_stamps, hist_poses, T_G_sm in snapshot:
            stamps.append(hist_stamps)
            poses.append(geo.compose_np(T_G_sm[None, :], hist_poses))
        if not stamps:
            return np.zeros((0,)), np.zeros((0, 7))
        return average_same_stamp(np.concatenate(stamps),
                                  np.concatenate(poses))
