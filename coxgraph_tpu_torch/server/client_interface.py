"""Client-side serving interface — port of
``coxgraph_tpu.server.client_interface``: the in-process equivalent of
the reference's client services and topics (get_client_submap /
get_all_submaps / get_pose_history, coxgraph_client.cpp:38-45; the
time_line and map_pose_updates topics, :120-153; loop-closure input).

The server talks to every robot through this interface; an in-process
robot wraps its MapperState. The control plane is host numpy: a served
submap's pose and history are numpy arrays, and its layer is a COPY of
the robot's pool row (``sm.get_layer``), because the robot keeps
integrating in place into the same pool while the server caches geometry
and registration points per layer version.

Where a ``HostMapper`` is attached (``mapper``) and its host mirror is
valid, the timeline, handles and pose lookups are served from the mirror
with no device read. Otherwise they read the collection's bookkeeping in
one batched device-to-host copy per call (``_host_view``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..core import voxel as vx
from ..mapper import submap_mapper as sm
from ..utils.tensorops import host, upload

Tensor = torch.Tensor


@dataclasses.dataclass
class SubmapHandle:
    """One served submap (the ClientSubmap message equivalent:
    coxgraph_msgs/ClientSubmap.msg — layer + pose + history)."""

    client_id: int
    client_submap_id: int
    layer: vx.TsdfLayer       # a copy of the robot's pool row
    T_cli_submap: np.ndarray  # submap pose in the client's odom frame
    start_time: float
    end_time: float
    hist_stamps: np.ndarray   # (H,)
    hist_poses: np.ndarray    # (H,7) T_submap_cam


def _host_view(col: sm.SubmapCollection) -> dict:
    """The collection's bookkeeping (submap count, history counts,
    intervals, submap poses, histories) on the host in ONE device read."""
    S, H = col.hist_stamps.shape
    flat = torch.cat([
        col.num_submaps.reshape(1).to(torch.float32),
        col.hist_count.to(torch.float32), col.start_time, col.end_time,
        col.T_odom_submap.reshape(-1), col.hist_stamps.reshape(-1),
        col.hist_poses.reshape(-1)]).cpu().numpy()
    sizes = [1, S, S, S, 7 * S, S * H, 7 * S * H]
    n, count, start, end, T, stamps, poses = np.split(
        flat, np.cumsum(sizes)[:-1])
    return {"n": int(n[0]), "count": count.astype(np.int64),
            "start": start, "end": end, "T": T.reshape(S, 7),
            "stamps": stamps.reshape(S, H), "poses": poses.reshape(S, H, 7)}


class InProcessClient:
    """Wraps a robot's mapper for server access. ``state`` belongs to the
    robot's own frame loop, which updates it in place under ``lock``; the
    server reads it and pushes pose updates and loop closures back."""

    def __init__(self, client_id: int, cfg: sm.MapperConfig,
                 state: sm.MapperState):
        self.client_id = client_id
        self.cfg = cfg
        self.state = state
        self.sent_submaps: set[int] = set()   # send-once policy
        self.bytes_sent = 0                   # bandwidth accounting
        self._published_poses: dict = {}      # csid → last-published pose
        self.mapping_enabled = True           # toggle_mapping service state
        self.finished = False                 # finish_map latched
        self.mapper = None                    # optional HostMapper to control
        # in-process calls cannot fail in transport, so this only ever
        # reads "future" or "success" (ClientHandler ReqState,
        # client_handler.h:106)
        self.req_state = "noninit"
        self.failures = 0
        # Deferred local PGO: with defer_local_pgo, receive_loop_closure
        # only ADDS the constraint and marks the solve pending; the
        # robot's own frame loop runs run_pending_local_pgo() between
        # windows, so a detector thread never holds the client lock
        # through a full LM solve.
        self.defer_local_pgo = False
        self.local_pgo_pending = False
        # Pause lock (the reference client's submap_proc_mutex_,
        # coxgraph_client.h:126): server-origin state mutations
        # (apply_pose_updates, receive_loop_closure, finish_map) and
        # submap serving take it, and a robot frame loop updating
        # ``state`` must hold it too. Every thread enqueues on the
        # device's one default stream, so this host order is also the
        # device order: a served layer copy is taken before the next
        # frame's in-place update.
        self.lock = threading.RLock()

    @property
    def device(self) -> torch.device:
        return self.state.frame_count.device

    # -- mapping control services -------------------------------------------

    def toggle_mapping(self, enable: bool) -> None:
        """Enable/disable integration — the tsdf client's toggle_mapping
        service (scripts/start_mapping.sh:2-5, vio_interface.h:68-80).
        The robot's frame loop consults ``mapping_enabled``."""
        self.mapping_enabled = bool(enable) and not self.finished
        if self.mapper is not None:
            self.mapper.mapping_enabled = self.mapping_enabled

    def finish_map(self) -> bool:
        """Finalize the map: a last local pose-graph optimization over the
        submap chain, then stop integrating (the voxgraph finish_map
        service, finish_experiment.sh:3-4). Idempotent."""
        with self.lock:
            if self.finished:
                return False
            if self.mapper is not None:
                self.mapper.finish_map()
                self.state = self.mapper.state
            elif int(self.state.collection.num_submaps) > 1:
                sm.optimize_local(self.cfg, self.state)
            self.finished = True
            self.mapping_enabled = False
            return True

    def _mirror(self):
        """The attached HostMapper, when its host mirror is usable: then
        the timeline, handles and pose lookups cost no device read.
        None ⇒ the device path."""
        m = self.mapper
        if m is not None and getattr(m, "mirror_enabled", False) \
                and m.host_submaps:
            return m
        return None

    # -- topics the client publishes --------------------------------------

    def timeline(self) -> Tuple[float, float]:
        with self.lock:
            m = self._mirror()
            if m is not None:
                return (m.host_submaps[0]["start"],
                        m.host_submaps[-1]["end"])
            v = _host_view(self.state.collection)
            if v["n"] == 0:
                return (0.0, -1.0)
            return (float(v["start"][0]), float(v["end"][v["n"] - 1]))

    def pose_update_deltas(self) -> List[Tuple[int, np.ndarray]]:
        """Submap poses changed since the last call — the client's
        map_pose_updates publication after local PGO
        (publishMapPoseUpdates, coxgraph_client.cpp:135-153 publishes only
        submaps whose pose moved)."""
        with self.lock:
            m = self._mirror()
            if m is not None:
                T = m.host_T_odom_submap
            else:
                v = _host_view(self.state.collection)
                T = v["T"][:v["n"]]
            out = []
            for k, Tk in enumerate(T):
                prev = self._published_poses.get(k)
                if prev is None or not np.allclose(prev, Tk, atol=1e-6):
                    out.append((k, Tk.copy()))
                    self._published_poses[k] = Tk.copy()
            return out

    # -- services ----------------------------------------------------------

    def _intervals(self, view: Optional[dict]):
        """[(start, end)] of the live submaps, from the mirror or a view."""
        m = self._mirror()
        if m is not None:
            return [(r["start"], r["end"]) for r in m.host_submaps]
        return list(zip(view["start"][:view["n"]], view["end"][:view["n"]]))

    def _view(self) -> Optional[dict]:
        """None when the mirror serves, else the collection's host view."""
        return None if self._mirror() is not None else _host_view(
            self.state.collection)

    @staticmethod
    def _index_at(intervals, t: float) -> Optional[int]:
        for k, (start, end) in enumerate(intervals):
            if start - 1e-6 <= t <= end + 1e-6:
                return k
        return None

    def _handle(self, k: int, view: Optional[dict]) -> SubmapHandle:
        layer = sm.get_layer(self.state.collection.layers, k)
        if k not in self.sent_submaps:
            self.sent_submaps.add(k)
            self.bytes_sent += vx.memory_size_bytes(layer)
        m = self._mirror()
        if m is not None and k < len(m.host_submaps):
            rec = m.host_submaps[k]
            return SubmapHandle(
                client_id=self.client_id, client_submap_id=k, layer=layer,
                T_cli_submap=m.host_T_odom_submap[k].copy(),
                start_time=rec["start"], end_time=rec["end"],
                hist_stamps=np.asarray(rec["stamps"]),
                hist_poses=(np.stack(rec["poses"]).astype(np.float32)
                            if rec["poses"]
                            else np.zeros((0, 7), np.float32)))
        if view is None:
            view = _host_view(self.state.collection)
        h = view["count"][k]
        return SubmapHandle(
            client_id=self.client_id, client_submap_id=k, layer=layer,
            T_cli_submap=view["T"][k].copy(),
            start_time=float(view["start"][k]),
            end_time=float(view["end"][k]),
            hist_stamps=view["stamps"][k, :h].copy(),
            hist_poses=view["poses"][k, :h].copy())

    def get_submap_by_time(self, t: float) -> Optional[SubmapHandle]:
        """None ⇒ t is ahead of this client's timeline ('future' fusion,
        reference ReqState::FUTURE, client_handler.h:106)."""
        with self.lock:
            view = self._view()
            k = self._index_at(self._intervals(view), t)
            self.req_state = "future" if k is None else "success"
            return None if k is None else self._handle(k, view)

    def get_all_submaps(self) -> List[SubmapHandle]:
        """Every submap (getAllClientSubmapsCallback under
        submap_proc_mutex_, coxgraph_client.cpp:83-106): one host view for
        all of them."""
        with self.lock:
            view = self._view()
            n = len(self._intervals(view))
            return [self._handle(k, view) for k in range(n)]

    def get_pose_history(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full odom-frame trajectory (stamps (N,), poses (N,7)) as numpy
        — the client's get_pose_history service (coxgraph_client.cpp:
        38-45, pulled by ClientHandler::requestPoseHistory,
        client_handler.cpp:149-160)."""
        with self.lock:
            m = self._mirror()
            if m is not None:
                ss, ps = [], []
                for k, rec in enumerate(m.host_submaps):
                    if not rec["stamps"]:
                        continue
                    T = m.host_T_odom_submap[k]
                    ss.append(np.asarray(rec["stamps"]))
                    ps.append(geo.compose_np(T[None, :],
                                             np.stack(rec["poses"])))
                if not ss:
                    return np.zeros((0,)), np.zeros((0, 7))
                return np.concatenate(ss), np.concatenate(ps)
            stamps, poses = sm.trajectory(self.state.collection)
            return host(stamps), host(poses)

    def lookup_pose_in_submap(self, k: int, t: float) -> np.ndarray:
        """T_submap_cam at time t from the submap's history (voxgraph
        lookupPoseByTime, coxgraph_client.cpp:53-57), interpolated on the
        host → (7,) numpy."""
        with self.lock:
            m = self._mirror()
            if m is not None and k < len(m.host_submaps) \
                    and m.host_submaps[k]["stamps"]:
                rec = m.host_submaps[k]
                return geo.lookup_pose_np(np.asarray(rec["stamps"]),
                                          np.stack(rec["poses"]), t)
            v = _host_view(self.state.collection)
            h = v["count"][k]
            return geo.lookup_pose_np(v["stamps"][k, :h],
                                      v["poses"][k, :h], t)

    # -- server → client ----------------------------------------------------

    def receive_loop_closure(self, t_a: float, t_b: float, T_ta_tb,
                             sqrt_info=None) -> bool:
        """Intra-client loop closure forwarded by the server
        (ClientHandler::pubLoopClosureMsg, coxgraph_server.cpp:217-222),
        converted from time-stamped poses to a submap constraint."""
        with self.lock:
            intervals = self._intervals(self._view())
            ka = self._index_at(intervals, t_a)
            kb = self._index_at(intervals, t_b)
            if ka is None or kb is None or ka == kb:
                return False
            T_sa_ta = self.lookup_pose_in_submap(ka, t_a)
            T_sb_tb = self.lookup_pose_in_submap(kb, t_b)
            T_sa_sb = geo.compose_np(
                geo.compose_np(T_sa_ta, host(T_ta_tb)),
                geo.inverse_np(T_sb_tb))
            dev = self.device
            si = None if sqrt_info is None else upload(
                np.asarray(host(sqrt_info), np.float32), dev)
            sm.add_loop_closure(self.state, ka, kb,
                                upload(T_sa_sb.astype(np.float32), dev), si)
            if self.defer_local_pgo:
                self.local_pgo_pending = True
            else:
                sm.optimize_local(self.cfg, self.state)
                if self.mapper is not None:
                    self.mapper.refresh_pose_mirror(state=self.state)
            return True

    def run_pending_local_pgo(self) -> bool:
        """Run the deferred local solve if closures accumulated since the
        last call (see defer_local_pgo) → whether a solve ran."""
        with self.lock:
            if not self.local_pgo_pending:
                return False
            self.local_pgo_pending = False
            sm.optimize_local(self.cfg, self.state)
            if self.mapper is not None:
                self.mapper.refresh_pose_mirror(state=self.state)
            return True

    def apply_pose_updates(self, updates: List[Tuple[int, np.ndarray]]
                           ) -> None:
        """Server-optimized submap poses pushed back (MapPoseUpdates,
        client_handler.cpp:106-129), written IN PLACE into the robot's
        pose table under the pause lock: with async PGO this arrives from
        the server's solve thread while the robot's frame loop runs."""
        with self.lock:
            col = self.state.collection
            m = self._mirror()
            if m is not None:
                T = np.tile(geo.identity_np(), (col.T_odom_submap.shape[0],
                                                1))
                for k, Tk in enumerate(m.host_T_odom_submap):
                    T[k] = Tk
            else:
                T = host(col.T_odom_submap).copy()
            for k, pose in updates:
                T[k] = np.asarray(pose)
                # don't echo server-pushed poses back as client updates
                self._published_poses[int(k)] = T[k].copy()
            col.T_odom_submap.copy_(upload(T, col.T_odom_submap.device))
            if self.mapper is not None:
                self.mapper.apply_pose_updates_host(updates)
