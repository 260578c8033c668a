"""Python face of the native message bus (``native/bus.cpp``) and the
remote client transport built on it — port of ``coxgraph_tpu.comm.bus``.

The reference wires clients to the server with TCPROS topics (time_line,
map_pose_updates, loop closures) and services (get_client_submap /
get_all_submaps, coxgraph_client.cpp:38-45); here the same roles run over
one C++ broker with latched pub/sub and request/reply. The server-side
``RemoteClient`` has the interface of
``server.client_interface.InProcessClient``, so ``CoxgraphServer`` code is
the same for in-process and remote robots; the robot side runs a
``ClientService`` pump next to its mapper loop.

Payloads are bytes: layers through the wire serializer, everything else
packed structs or pickles of numpy arrays and Python scalars, never of a
tensor. So the frames are the JAX package's frames, and a JAX robot
serves a port server (and the reverse) over one broker.
"""

from __future__ import annotations

import ctypes
import pickle
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from .. import runtime
from ..core import voxel as vx
from ..native import lib
from ..utils.tensorops import host
from . import wire


class Broker:
    """In-process handle on the C++ broker (one per deployment)."""

    def __init__(self, port: int):
        self.port = port
        self._id = lib().cox_bus_serve(port)
        if self._id < 0:
            raise OSError(f"cannot bind bus broker on port {port}")

    def close(self) -> None:
        if self._id >= 0:
            lib().cox_bus_stop(self._id)
            self._id = -1


def _ptr(payload: bytes):
    """(pointer or None, length) of a payload for the C calls; the array
    keeps the bytes alive for the call."""
    buf = np.frombuffer(payload, np.uint8)
    return buf, (buf.ctypes.data if len(buf) else None), len(buf)


class BusClient:
    """One connection to the broker (pub/sub + request/reply)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._h = lib().cox_bus_connect(host.encode(), port)
        if self._h < 0:
            raise OSError(f"cannot connect to bus at {host}:{port}")

    def close(self) -> None:
        if self._h >= 0:
            lib().cox_bus_close(self._h)
            self._h = -1

    def subscribe(self, topic: str) -> None:
        if lib().cox_bus_subscribe(self._h, topic.encode()) != 0:
            raise OSError("subscribe failed")

    def advertise(self, service: str) -> None:
        if lib().cox_bus_advertise(self._h, service.encode()) != 0:
            raise OSError("advertise failed")

    def publish(self, topic: str, payload: bytes) -> None:
        _buf, p, n = _ptr(payload)
        if lib().cox_bus_publish(self._h, topic.encode(), p, n) != 0:
            raise OSError("publish failed")

    def _slot(self) -> Tuple[str, bytes, int]:
        L = lib()
        n = L.cox_bus_msg_len(self._h)
        tbuf = ctypes.create_string_buffer(512)
        L.cox_bus_msg_topic(self._h, tbuf, 512)
        out = np.empty(n, np.uint8)
        if n:
            L.cox_bus_msg_data(self._h, out.ctypes.data, n)
        return (tbuf.value.decode(), out.tobytes(),
                L.cox_bus_msg_reqid(self._h))

    def poll(self, timeout_ms: int = 0):
        """→ None | ('pub', topic, payload) | ('req', service, payload,
        reqid)."""
        t = lib().cox_bus_poll(self._h, timeout_ms)
        if t <= 0:
            if t < 0:
                raise OSError("bus connection closed")
            return None
        topic, payload, reqid = self._slot()
        if t == 2:
            return ("pub", topic, payload)
        return ("req", topic, payload, reqid)

    def request(self, service: str, payload: bytes = b"",
                timeout_ms: int = 30_000) -> bytes:
        _buf, p, n_in = _ptr(payload)
        n = lib().cox_bus_request(self._h, service.encode(), p, n_in,
                                  timeout_ms)
        if n < 0:
            raise TimeoutError(f"request {service!r} failed/timed out")
        out = np.empty(int(n), np.uint8)
        if n:
            lib().cox_bus_msg_data(self._h, out.ctypes.data, int(n))
        return out.tobytes()

    def reply(self, reqid: int, payload: bytes) -> None:
        _buf, p, n = _ptr(payload)
        if lib().cox_bus_reply(self._h, reqid, p, n) != 0:
            raise OSError("reply failed")


# ---------------------------------------------------------------------------
# Remote client transport (ClientHandler ⇄ client services over the bus)
# ---------------------------------------------------------------------------


def _pack_handle(spec: vx.VoxelGridSpec, h) -> bytes:
    """SubmapHandle → bytes (the layer through the wire serializer)."""
    meta = pickle.dumps({
        "client_id": h.client_id,
        "client_submap_id": h.client_submap_id,
        "T_cli_submap": np.asarray(host(h.T_cli_submap)),
        "start_time": h.start_time,
        "end_time": h.end_time,
        "hist_stamps": np.asarray(host(h.hist_stamps)),
        "hist_poses": np.asarray(host(h.hist_poses)),
    }, protocol=4)
    layer_bytes = wire.serialize_layer(spec, h.layer)
    return struct.pack("<II", len(meta), len(layer_bytes)) + meta + \
        layer_bytes


def _unpack_handle(spec: vx.VoxelGridSpec, buf: bytes, device):
    from ..server.client_interface import SubmapHandle

    ml, ll = struct.unpack_from("<II", buf, 0)
    meta = pickle.loads(buf[8:8 + ml])
    layer = wire.deserialize_layer(spec, buf[8 + ml:8 + ml + ll], device)
    return SubmapHandle(
        client_id=meta["client_id"],
        client_submap_id=meta["client_submap_id"],
        layer=layer,
        # poses stay host numpy (the server consumes them on the host)
        T_cli_submap=np.asarray(meta["T_cli_submap"]),
        start_time=meta["start_time"], end_time=meta["end_time"],
        hist_stamps=np.asarray(meta["hist_stamps"]),
        hist_poses=np.asarray(meta["hist_poses"]))


class ClientService:
    """Robot-side pump: serves this robot's submaps and poses over the bus
    and applies server pushes. Call ``step()`` from the robot's frame loop
    (the reference client spins its service callbacks the same way).
    ``client`` is an ``InProcessClient``; every state change it makes
    happens under its lock."""

    def __init__(self, port: int, client, spec: vx.VoxelGridSpec):
        self.client = client
        self.spec = spec
        cid = client.client_id
        self.bus = BusClient(port)
        for srv in ("get_submap_by_time", "get_all_submaps",
                    "lookup_pose", "loop_closure", "pose_updates",
                    "toggle_mapping", "finish_map", "get_pose_history"):
            self.bus.advertise(f"client{cid}/{srv}")

    def publish_timeline(self) -> None:
        t0, t1 = self.client.timeline()
        self.bus.publish(f"client{self.client.client_id}/time_line",
                         struct.pack("<dd", t0, t1))

    def publish_pose_updates(self) -> None:
        """Push local-PGO pose changes to the server (the client's
        map_pose_updates topic, coxgraph_client.cpp:135-153)."""
        ups = self.client.pose_update_deltas()
        if ups:
            self.bus.publish(
                f"client{self.client.client_id}/map_pose_updates",
                pickle.dumps([(int(k), np.asarray(p)) for k, p in ups],
                             protocol=4))

    def publish_submap_mesh(self, mesh_msg) -> None:
        """Push a finished submap's mesh and trajectory to the server's
        MeshCollection (submap_mesh_with_traj topic,
        map_server.cpp:119-152 → client_handler.h:185-193). The (client,
        submap) ids travel inside the message."""
        self.bus.publish(f"client{self.client.client_id}/submap_mesh",
                         mesh_msg.pack())

    def _serve(self, name: str, payload: bytes) -> bytes:
        c = self.client
        if name == "get_submap_by_time":
            (t,) = struct.unpack("<d", payload)
            h = c.get_submap_by_time(t)
            return b"" if h is None else _pack_handle(self.spec, h)
        if name == "get_all_submaps":
            parts = [_pack_handle(self.spec, h) for h in c.get_all_submaps()]
            return struct.pack("<I", len(parts)) + b"".join(
                struct.pack("<I", len(p)) + p for p in parts)
        if name == "lookup_pose":
            k, t = struct.unpack("<id", payload)
            return np.asarray(host(c.lookup_pose_in_submap(k, t)),
                              np.float32).tobytes()
        if name == "loop_closure":
            d = pickle.loads(payload)
            ok = c.receive_loop_closure(d["t_a"], d["t_b"],
                                        np.asarray(d["T"]), d["sqrt_info"])
            return struct.pack("<B", int(ok))
        if name == "pose_updates":
            c.apply_pose_updates([(int(k), np.asarray(p))
                                  for k, p in pickle.loads(payload)])
            return b"\x01"
        if name == "toggle_mapping":
            # start_mapping.sh:2-5 / vio_interface.h:68-80 service
            c.toggle_mapping(bool(payload[0]))
            return b"\x01"
        if name == "finish_map":
            # finish_experiment.sh:3-4 client finish_map service
            return struct.pack("<B", int(c.finish_map()))
        if name == "get_pose_history":
            # client get_pose_history service (coxgraph_client.cpp:38-45)
            stamps, poses = c.get_pose_history()
            return pickle.dumps((np.asarray(host(stamps)),
                                 np.asarray(host(poses))), protocol=4)
        return b""

    def step(self, timeout_ms: int = 0) -> bool:
        """Serve at most one pending request. → whether a message came."""
        msg = self.bus.poll(timeout_ms)
        if msg is None or msg[0] != "req":
            return msg is not None
        _, service, payload, reqid = msg
        self.bus.reply(reqid, self._serve(service.split("/", 1)[1], payload))
        return True


class ReqState:
    """Last-request outcome of a RemoteClient — the reference
    ClientHandler's ReqState (client_handler.h:106). FAILED: the transport
    broke (dead or slow robot, RPC timeout); FUTURE: the robot answered
    but the requested time is ahead of its map."""

    NONINIT = "noninit"
    FAILED = "failed"
    FUTURE = "future"
    SUCCESS = "success"


class RemoteClient:
    """Server-side proxy with the InProcessClient interface, backed by bus
    RPC (the reference's ClientHandler, client_handler.cpp:82-160).
    Served layers are decoded onto ``device`` (None: the card).

    RPC failures never raise out of this class: every method catches the
    bus timeout, records ``req_state = ReqState.FAILED`` (and counts it)
    and returns a neutral value; the server requeues the fusion and
    retries on later timeline updates (client_handler.cpp:103,
    coxgraph_server.cpp:287-295)."""

    def __init__(self, port: int, client_id: int, spec: vx.VoxelGridSpec,
                 timeout_ms: int = 60_000, device=None):
        self.client_id = client_id
        self.spec = spec
        self.timeout_ms = timeout_ms
        self.device = runtime.require_cuda() if device is None else device
        self.bus = BusClient(port)
        self.bus.subscribe(f"client{client_id}/time_line")
        self._timeline = (0.0, -1.0)
        # per-transfer bandwidth accounting (EvalDataPublisher parity,
        # client_handler.cpp:92-95)
        self.bandwidth = wire.BandwidthLog()
        self.req_state = ReqState.NONINIT
        self.failures = 0

    def _srv(self, name: str) -> str:
        return f"client{self.client_id}/{name}"

    def _request(self, name: str, payload: bytes = b"") -> Optional[bytes]:
        """RPC with FAILED-state capture → reply bytes, or None when the
        robot is unreachable (timeout, dropped connection)."""
        try:
            out = self.bus.request(self._srv(name), payload, self.timeout_ms)
        except (TimeoutError, OSError):
            self.req_state = ReqState.FAILED
            self.failures += 1
            return None
        self.req_state = ReqState.SUCCESS
        return out

    def timeline(self) -> Tuple[float, float]:
        while True:
            msg = self.bus.poll(0)
            if msg is None:
                break
            if msg[0] == "pub" and msg[1].endswith("time_line"):
                self._timeline = struct.unpack("<dd", msg[2])
        return self._timeline

    def get_submap_by_time(self, t: float):
        t0 = time.monotonic()
        out = self._request("get_submap_by_time", struct.pack("<d", t))
        if out is None:
            return None                              # FAILED
        self.bandwidth.record(f"client{self.client_id}/submap", len(out),
                              time.monotonic() - t0)
        if not out:
            self.req_state = ReqState.FUTURE         # answered: no map
            return None
        return _unpack_handle(self.spec, out, self.device)

    def get_all_submaps(self) -> List:
        t0 = time.monotonic()
        out = self._request("get_all_submaps")
        if out is None:
            return []                                # FAILED
        self.bandwidth.record(f"client{self.client_id}/all_submaps",
                              len(out), time.monotonic() - t0)
        if not out:
            return []
        (n,) = struct.unpack_from("<I", out, 0)
        off = 4
        handles = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", out, off)
            off += 4
            handles.append(_unpack_handle(self.spec, out[off:off + ln],
                                          self.device))
            off += ln
        return handles

    def lookup_pose_in_submap(self, k: int, t: float):
        out = self._request("lookup_pose", struct.pack("<id", k, t))
        if not out:
            return None                              # FAILED / no history
        return np.frombuffer(out, np.float32)

    def receive_loop_closure(self, t_a: float, t_b: float, T,
                             sqrt_info=None) -> bool:
        payload = pickle.dumps({
            "t_a": t_a, "t_b": t_b, "T": np.asarray(host(T)),
            "sqrt_info": None if sqrt_info is None
            else np.asarray(host(sqrt_info))}, protocol=4)
        out = self._request("loop_closure", payload)
        return bool(out and out[0])

    def apply_pose_updates(self, updates) -> None:
        payload = pickle.dumps([(int(k), np.asarray(host(p)))
                                for k, p in updates], protocol=4)
        if self._request("pose_updates", payload) is None:
            return     # unreachable robot: the next optimize re-pushes
        # also broadcast each optimized pose as a stamped MapTransform
        # (sm_pose_tf_pub_, client_handler.cpp:60, MapTransform.msg:1-4)
        now = time.time()
        for k, p in updates:
            self.bus.publish(self._srv("submap_pose_tf"),
                             wire.pack_map_transform(now, int(k), p))

    def toggle_mapping(self, enable: bool) -> None:
        self._request("toggle_mapping", struct.pack("<B", int(enable)))

    def finish_map(self) -> bool:
        out = self._request("finish_map")
        return bool(out and out[0])

    def get_pose_history(self):
        """ClientHandler::requestPoseHistory (client_handler.cpp:149-160)
        → (stamps (N,), poses (N,7)) in the client's odom frame; empty
        arrays when the robot is unreachable
        (coxgraph_server.cpp:150-155)."""
        out = self._request("get_pose_history")
        if not out:
            return np.zeros((0,)), np.zeros((0, 7), np.float32)
        return pickle.loads(out)


# ---------------------------------------------------------------------------
# Server-side bus surface (the coxgraph_server node's topics + services)
# ---------------------------------------------------------------------------


class ServerService:
    """Bus pump exposing a CoxgraphServer to other processes: the map
    fusion topic and the get_final_global_mesh / get_pose_history /
    need_to_fuse services (coxgraph_server.cpp:87-95), control_trigger /
    state_query (distribution_controller.h:49-55), and the per-client
    map_pose_updates and submap_mesh subscriptions
    (client_handler.cpp:106-129, client_handler.h:185-193).

    Call ``step()`` from the server's control loop."""

    def __init__(self, port: int, server):
        self.server = server
        self.bus = BusClient(port)
        self.bus.subscribe("map_fusion_in")
        for cid in server.clients:
            self.bus.subscribe(f"client{cid}/map_pose_updates")
            self.bus.subscribe(f"client{cid}/submap_mesh")
        for srv in ("need_to_fuse", "control_trigger", "state_query",
                    "get_final_global_mesh", "get_pose_history",
                    "save_pose_history"):
            self.bus.advertise(f"server/{srv}")

    def _on_pub(self, topic: str, payload: bytes) -> None:
        if topic == "map_fusion_in":
            from ..server.fusion_server import MapFusionMsg

            d = pickle.loads(payload)
            self.server.map_fusion(MapFusionMsg(
                from_client=d["from_client"], from_time=d["from_time"],
                to_client=d["to_client"], to_time=d["to_time"],
                T_from_to=np.asarray(d["T"], np.float32),
                sqrt_info=None if d["sqrt_info"] is None
                else np.asarray(d["sqrt_info"], np.float32)))
        elif topic.endswith("/map_pose_updates"):
            cid = int(topic.split("/", 1)[0][len("client"):])
            self.server.client_pose_updates(
                cid, [(int(k), np.asarray(p))
                      for k, p in pickle.loads(payload)])
        elif topic.endswith("/submap_mesh"):
            from . import mesh_comm

            m = mesh_comm.MeshWithHistory.unpack(payload)
            self.server.add_submap_mesh(m.client_id, m.submap_id, m)

    def _serve(self, name: str, payload: bytes) -> bytes:
        s = self.server
        if name == "need_to_fuse":
            a, b, t = struct.unpack("<iid", payload)
            return struct.pack("<B", int(s.need_to_fuse(a, b, t)))
        if name == "control_trigger":
            s.control_trigger(bool(payload[0]))
            return b"\x01"
        if name == "state_query":
            q = s.state_query()
            return pickle.dumps(
                {"n_submaps": q["n_submaps"],
                 "aabbs": [np.asarray(a) for a in q["aabbs"]],
                 "resources": q.get("resources", {})}, protocol=4)
        if name == "get_final_global_mesh":
            # FilePath.srv semantics: empty path = no export
            _, verts, _ = s.get_final_global_mesh(payload.decode() or None)
            return struct.pack("<I", int(verts.reshape(-1, 3).shape[0]))
        if name == "get_pose_history":
            (cid,) = struct.unpack("<i", payload)
            stamps, poses = s.pose_history(cid)
            return pickle.dumps((np.asarray(stamps), np.asarray(poses)),
                                protocol=4)
        if name == "save_pose_history":
            # the FilePath get_pose_history (getPoseHistoryCallback,
            # coxgraph_server.cpp:143-187)
            return s.save_pose_history(payload.decode()).encode()
        return b""

    def step(self, timeout_ms: int = 0) -> bool:
        """Process at most one bus event. → whether one was processed."""
        msg = self.bus.poll(timeout_ms)
        if msg is None:
            return False
        if msg[0] == "pub":
            self._on_pub(msg[1], msg[2])
        else:
            _, service, payload, reqid = msg
            self.bus.reply(reqid, self._serve(service.split("/", 1)[1],
                                              payload))
        return True

    def drain(self) -> int:
        """Process everything pending. → number of events."""
        n = 0
        while self.step(0):
            n += 1
        return n


class RemoteVIO:
    """Bus face of the VIO adapter for out-of-process SLAM frontends:
    publish_loop_closure → the map_fusion_in topic (LoopClosurePublisher,
    loop_closure_publisher.h:71-136), need_to_fuse → a server service with
    a cached answer (:150-169), control_trigger / state_query service
    clients (distribution_controller.h:49-55)."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout_ms: int = 30_000, ntf_cache_ttl: float = 20.0):
        self.bus = BusClient(port, host)
        self.timeout_ms = timeout_ms
        # need_to_fuse answers age out after ntf_cache_ttl seconds of DATA
        # time (the server's refuse_interval, server.yaml:15), the pull
        # form of the reference's updateNeedToFuse refresh
        # (vio_interface.h:82-113)
        self.ntf_cache_ttl = ntf_cache_ttl
        self._ntf_cache: dict = {}   # key → (answer, query data-time)

    def publish_loop_closure(self, from_client: int, from_time: float,
                             to_client: int, to_time: float, T,
                             sqrt_info=None) -> None:
        """Fire-and-forget, like the reference's topic publication."""
        self.bus.publish("map_fusion_in", pickle.dumps({
            "from_client": from_client, "from_time": from_time,
            "to_client": to_client, "to_time": to_time,
            "T": np.asarray(host(T)),
            "sqrt_info": None if sqrt_info is None
            else np.asarray(host(sqrt_info)),
        }, protocol=4))

    def need_to_fuse(self, cid_a: int, cid_b: int, t: float,
                     use_cache: bool = True) -> bool:
        key = (min(cid_a, cid_b), max(cid_a, cid_b))
        if use_cache and key in self._ntf_cache:
            val, t_cached = self._ntf_cache[key]
            if abs(t - t_cached) < self.ntf_cache_ttl:
                return val
        out = self.bus.request("server/need_to_fuse",
                               struct.pack("<iid", cid_a, cid_b, t),
                               self.timeout_ms)
        val = bool(out and out[0])
        self._ntf_cache[key] = (val, t)
        return val

    def control_trigger(self, in_control: bool) -> None:
        self.bus.request("server/control_trigger",
                         struct.pack("<B", int(in_control)), self.timeout_ms)

    def state_query(self) -> dict:
        return pickle.loads(
            self.bus.request("server/state_query", b"", self.timeout_ms))

    def get_final_global_mesh(self, path: str = "") -> int:
        out = self.bus.request("server/get_final_global_mesh",
                               path.encode(), self.timeout_ms)
        return struct.unpack("<I", out)[0]

    def get_pose_history(self, client_id: int):
        out = self.bus.request("server/get_pose_history",
                               struct.pack("<i", client_id), self.timeout_ms)
        return pickle.loads(out)

    def save_pose_history(self, dir_path: str) -> str:
        """The FilePath get_pose_history (finish_experiment.sh:6): every
        client's global-frame trajectory into one TUM file → its path."""
        out = self.bus.request("server/save_pose_history",
                               dir_path.encode(), self.timeout_ms)
        return out.decode()

    def toggle_mapping(self, client_id: int, enable: bool) -> bool:
        """toggleMapping service client (vio_interface.h:68-80,
        start_mapping.sh:2-5) aimed at one robot → acked (False: that
        robot's service is not up yet)."""
        out = self.bus.request(f"client{client_id}/toggle_mapping",
                               struct.pack("<B", int(enable)),
                               self.timeout_ms)
        return bool(out and out[0])

    def finish_map(self, client_id: int) -> bool:
        """Client finish_map service call (finish_experiment.sh:3-4)."""
        out = self.bus.request(f"client{client_id}/finish_map", b"",
                               self.timeout_ms)
        return bool(out and out[0])
