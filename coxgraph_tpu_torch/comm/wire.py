"""Submap wire format and bandwidth accounting — port of
``coxgraph_tpu.comm.wire``: the host transport tier that plays the
reference's ROS topics and services for submap hand-off
(msgFromCliSubmap / cliSubmapFromMsg, msg_converter.h:46-118, with
sizeOfMsg accounting :149-167 via EvalDataPublisher).

Encoding is the native C++ serializer (``native/serializer.cpp``, a copy
of the JAX package's): an occupancy bitmap and 7-byte quantized voxels.
The bytes are the JAX package's bytes for the same layer.

``serialize_layer`` reads back only the ``num_blocks`` live rows of a
layer, in one device-to-host copy; ``deserialize_layer`` allocates the
decoded blocks with ``vx.allocate_blocks`` on the target device and
writes the rows through ``lookup_block`` slots (the allocator gives new
blocks slots in grid-cell order, not in decoded order).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import time
from typing import List

import numpy as np
import torch

from .. import runtime
from ..core import voxel as vx
from ..native import lib
from ..utils.tensorops import host, upload

_HDR = struct.Struct("<III dd")  # client_id, submap_id, n_hist, t0, t1


def live_rows(layer: vx.TsdfLayer):
    """The live blocks of a layer on the host → (coords (n,3) int32,
    sdf (n,v³), weight (n,v³), color (n,3·v³)) f32 numpy: one read of
    ``num_blocks``, then one copy of the n live rows."""
    n = int(layer.num_blocks)
    v3 = layer.sdf.shape[1]
    flat = torch.cat([layer.block_coords[:n].reshape(-1).view(torch.float32),
                      layer.sdf[:n].reshape(-1), layer.weight[:n].reshape(-1),
                      layer.color[:n].reshape(-1)]).cpu().numpy()
    coords, sdf, w, c = np.split(flat, np.cumsum([3 * n, n * v3, n * v3]))
    return (coords.view(np.int32).reshape(n, 3), sdf.reshape(n, v3),
            w.reshape(n, v3), c.reshape(n, 3 * v3))


def serialize_layer(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer) -> bytes:
    """Encode the live blocks of a layer → bytes."""
    L = lib()
    coords, sdf, w, c = live_rows(layer)
    n = coords.shape[0]
    vps = spec.voxels_per_side
    cap = L.cox_serialized_bound(n, vps)
    out = np.empty(cap, np.uint8)
    written = L.cox_serialize(
        coords.ctypes.data, sdf.ctypes.data, w.ctypes.data, c.ctypes.data,
        n, vps, ctypes.c_float(spec.truncation),
        ctypes.c_float(spec.voxel_size), out.ctypes.data, cap)
    if written == 0:
        raise RuntimeError("serialization failed")
    return out[:written].tobytes()


def deserialize_layer(spec: vx.VoxelGridSpec, buf: bytes,
                      device=None) -> vx.TsdfLayer:
    """Decode bytes → a fresh TsdfLayer on ``device`` (None: the card)
    holding the decoded blocks."""
    device = runtime.require_cuda() if device is None else device
    L = lib()
    nb, vps = ctypes.c_uint32(), ctypes.c_uint32()
    trunc, vsz = ctypes.c_float(), ctypes.c_float()
    b = np.frombuffer(buf, np.uint8)
    rc = L.cox_peek(b.ctypes.data, len(buf), ctypes.byref(nb),
                    ctypes.byref(vps), ctypes.byref(trunc),
                    ctypes.byref(vsz))
    if rc != 0:
        raise ValueError(f"bad wire buffer (rc={rc})")
    n, v = nb.value, vps.value
    if v != spec.voxels_per_side:
        raise ValueError(f"voxels_per_side {v} != {spec.voxels_per_side}")
    if abs(vsz.value - spec.voxel_size) >= 1e-6:
        raise ValueError(f"voxel_size {vsz.value} != {spec.voxel_size}")
    if n > spec.max_blocks:
        raise ValueError(f"{n} blocks > max_blocks {spec.max_blocks}")
    coords = np.empty((n, 3), np.int32)
    sdf = np.empty((n, v ** 3), np.float32)     # flat rows, like the pool
    w = np.empty((n, v ** 3), np.float32)
    c = np.empty((n, 3 * v ** 3), np.float32)   # planar channel rows
    rc = L.cox_deserialize(b.ctypes.data, len(buf), coords.ctypes.data,
                           sdf.ctypes.data, w.ctypes.data, c.ctypes.data)
    if rc != 0:
        raise ValueError(f"deserialize failed (rc={rc})")
    layer = vx.create_tsdf_layer(spec, device)
    coords_d = upload(coords, device)
    layer = vx.allocate_blocks(spec, layer, coords_d)
    slots = vx.lookup_block(spec, layer, coords_d).long()
    for name, rows in (("sdf", sdf), ("weight", w), ("color", c)):
        getattr(layer, name).index_copy_(0, slots, upload(rows, device))
    return layer


@dataclasses.dataclass
class BandwidthEvent:
    """Per-transfer record (node_evaluator/Bandwidth equivalent,
    eval_data_publisher.h:23-31)."""

    name: str
    n_bytes: int
    t_pub: float
    t_recv: float


class BandwidthLog:
    def __init__(self):
        self.events: List[BandwidthEvent] = []

    def record(self, name: str, n_bytes: int, t_pub: float) -> None:
        self.events.append(BandwidthEvent(name, n_bytes, t_pub, time.time()))

    def total_bytes(self) -> int:
        return sum(e.n_bytes for e in self.events)

    def summary(self) -> str:
        mb = self.total_bytes() / 1e6
        return f"{len(self.events)} transfers, {mb:.2f} MB"


def pack_submap_msg(spec: vx.VoxelGridSpec, client_id: int, submap_id: int,
                    layer: vx.TsdfLayer, T_cli_submap, t0: float, t1: float,
                    hist_stamps, hist_poses, mesh_points=None,
                    mesh_colors=None) -> bytes:
    """Full ClientSubmap message: header, pose, history, the
    length-prefixed encoded layer and an optional submap-frame mesh
    point cloud (coxgraph_msgs/ClientSubmap.msg:1-3; the recover-mode
    cloud the client attaches to the active submap,
    coxgraph_client.h:162-165)."""
    hs = np.asarray(host(hist_stamps), np.float64)
    hp = np.asarray(host(hist_poses), np.float32).reshape(-1, 7)
    hdr = _HDR.pack(client_id, submap_id, len(hs), t0, t1)
    pose = np.asarray(host(T_cli_submap), np.float32).tobytes()
    lay = serialize_layer(spec, layer)
    if mesh_points is None:
        cloud = struct.pack("<I", 0)
    else:
        pts = np.ascontiguousarray(mesh_points, np.float32).reshape(-1, 3)
        cols = (np.full((pts.shape[0], 3), 128, np.uint8)
                if mesh_colors is None
                else np.ascontiguousarray(mesh_colors,
                                          np.uint8).reshape(-1, 3))
        cloud = (struct.pack("<I", pts.shape[0]) + pts.tobytes()
                 + cols.tobytes())
    return (hdr + pose + hs.tobytes() + hp.tobytes()
            + struct.pack("<I", len(lay)) + lay + cloud)


def unpack_submap_msg(spec: vx.VoxelGridSpec, buf: bytes, device=None):
    """→ dict of the message's fields; the pose and history as host
    numpy, the layer on ``device`` (None: the card)."""
    cid, sid, n_hist, t0, t1 = _HDR.unpack_from(buf, 0)
    off = _HDR.size
    pose = np.frombuffer(buf, np.float32, 7, off).copy()
    off += 28
    hs = np.frombuffer(buf, np.float64, n_hist, off).copy()
    off += 8 * n_hist
    hp = np.frombuffer(buf, np.float32, 7 * n_hist, off).reshape(
        n_hist, 7).copy()
    off += 28 * n_hist
    (lay_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    layer = deserialize_layer(spec, buf[off:off + lay_len], device)
    off += lay_len
    (n_pts,) = struct.unpack_from("<I", buf, off)
    off += 4
    pts = cols = None
    if n_pts:
        pts = np.frombuffer(buf, np.float32, 3 * n_pts, off).reshape(
            n_pts, 3).copy()
        off += 12 * n_pts
        cols = np.frombuffer(buf, np.uint8, 3 * n_pts, off).reshape(
            n_pts, 3).copy()
    return dict(client_id=cid, submap_id=sid, t0=t0, t1=t1,
                T_cli_submap=pose, hist_stamps=hs, hist_poses=hp,
                layer=layer, mesh_points=pts, mesh_colors=cols)


_MAP_TF = struct.Struct("<dh")


def pack_map_transform(stamp: float, submap_id: int, pose7) -> bytes:
    """MapTransform message: a stamped optimized submap pose the server
    broadcasts back to a client (coxgraph_msgs/MapTransform.msg:1-4,
    sm_pose_tf_pub_, client_handler.cpp:60)."""
    return (_MAP_TF.pack(stamp, submap_id)
            + np.asarray(host(pose7), np.float32).tobytes())


def unpack_map_transform(buf: bytes):
    stamp, sid = _MAP_TF.unpack_from(buf, 0)
    pose = np.frombuffer(buf, np.float32, 7, _MAP_TF.size).copy()
    return stamp, sid, pose


def pack_tf_set(stamp: float, frames: dict) -> bytes:
    """One stamped TF-tree snapshot {(parent, child): pose7}: the body of
    the timer-driven TF broadcast (TfPublisher, tf_publisher.h:38-40;
    global_tf_controller.h:122)."""
    parts = [struct.pack("<dI", stamp, len(frames))]
    for (parent, child), pose in frames.items():
        p = parent.encode()
        c = child.encode()
        parts.append(struct.pack("<HH", len(p), len(c)) + p + c
                     + np.asarray(host(pose), np.float32).tobytes())
    return b"".join(parts)


def unpack_tf_set(buf: bytes):
    """→ (stamp, {(parent, child): pose7 np.float32})."""
    stamp, n = struct.unpack_from("<dI", buf, 0)
    off = 12
    out = {}
    for _ in range(n):
        lp, lc = struct.unpack_from("<HH", buf, off)
        off += 4
        parent = buf[off:off + lp].decode()
        off += lp
        child = buf[off:off + lc].decode()
        off += lc
        out[(parent, child)] = np.frombuffer(buf, np.float32, 7, off).copy()
        off += 28
    return stamp, out
