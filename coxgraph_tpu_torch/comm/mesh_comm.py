"""Mesh-with-history transport — port of ``coxgraph_tpu.comm.mesh_comm``,
the reference's L2 map-communication tier: ship a compact submap MESH
whose triangles remember which keyframes observed them, decode it into
per-keyframe point clouds, and re-integrate those into a fresh TSDF at the
receiver (MeshConverter, mesh_converter.h:93-265; TsdfRecover,
tsdf_recover.h:59-99).

The wire mesh is an indexed mesh vertex-clustered to voxel scale
(ops/mesh_post); every face carries run-length observation history over
the keyframes (mesh_converter.h:137-142). Encoding and decoding are host
numpy, byte for byte the JAX package's. Recovery runs on the layer's
device: "projective" splats each keyframe's points into a virtual RGB-D
frame (``render_points``) and runs the projective integrator (K1 on the
card); "merged" feeds each cloud to the point-cloud integrator.

``render_points`` picks each pixel's colour explicitly: the point of least
z, then of lowest index. (The JAX package scatters colours in descending
z and lets the last write win, an order a scatter with duplicate indices
does not define on CUDA.) Depth is the per-pixel minimum either way.

This transport is OPTIONAL: comm/wire.py ships quantized voxel blocks
directly and is the default; mesh_comm carries only the surface crust.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..ops import mesh as mesh_ops
from ..ops import mesh_post
from ..ops import points as pts_ops
from ..ops import tsdf as tsdf_ops
from ..utils.tensorops import upload

Tensor = torch.Tensor

_HDR = struct.Struct("<II II II dd 3f f")  # cid, csid, n_verts, n_faces,
#                                  n_kf, max_runs, t0, t1, aabb_min, scale

RUN_SENTINEL = 0xFFFF   # unused observation-run slot


@dataclasses.dataclass
class MeshWithHistory:
    """The wire message (coxgraph_msgs/MeshWithTrajectory: a voxblox
    MultiMesh and a nav_msgs/Path)."""

    client_id: int
    submap_id: int
    t0: float
    t1: float
    aabb_min: np.ndarray       # (3,) f32
    scale: float               # quantization step (m per uint16 LSB)
    qverts: np.ndarray         # (V,3) uint16 quantized submap-frame verts
    vcolors: np.ndarray        # (V,3) uint8
    faces: np.ndarray          # (F,3) uint32
    frame_runs: np.ndarray     # (F,P,2) uint16 [start,end] keyframe runs
    #                            per face, longest first (unused slots =
    #                            RUN_SENTINEL)
    kf_stamps: np.ndarray      # (K,) f64
    kf_poses: np.ndarray       # (K,7) f32 T_submap_cam

    @property
    def frame_idx(self) -> np.ndarray:
        """(F,) first observing keyframe per face: the earliest start over
        the face's runs (runs are ranked by length); 0 for a face with no
        run."""
        if self.frame_runs.shape[0] == 0:
            return np.zeros((0,), np.uint16)
        starts = self.frame_runs[:, :, 0].astype(np.int32)
        starts = np.where(starts == RUN_SENTINEL, np.iinfo(np.int32).max,
                          starts)
        first = starts.min(axis=1)
        return np.where(first == np.iinfo(np.int32).max, 0,
                        first).astype(np.uint16)

    def pack(self) -> bytes:
        """→ bytes (the ROS-serialization equivalent; sizeOfMsg analogue,
        msg_converter.h:149-167)."""
        head = _HDR.pack(self.client_id, self.submap_id,
                         self.qverts.shape[0], self.faces.shape[0],
                         self.kf_stamps.shape[0], self.frame_runs.shape[1],
                         self.t0, self.t1, *map(float, self.aabb_min),
                         self.scale)
        # face indices ride as u16 whenever the vertex count allows
        fdtype = np.uint16 if self.qverts.shape[0] <= 0xFFFF else np.uint32
        return b"".join([
            head,
            np.ascontiguousarray(self.qverts, np.uint16).tobytes(),
            np.ascontiguousarray(self.vcolors, np.uint8).tobytes(),
            np.ascontiguousarray(self.faces.astype(fdtype)).tobytes(),
            np.ascontiguousarray(self.frame_runs, np.uint16).tobytes(),
            np.ascontiguousarray(self.kf_stamps, np.float64).tobytes(),
            np.ascontiguousarray(self.kf_poses, np.float32).tobytes(),
        ])

    @staticmethod
    def unpack(buf: bytes) -> "MeshWithHistory":
        (cid, csid, V, F, K, P, t0, t1, ax, ay, az,
         scale) = _HDR.unpack_from(buf, 0)
        off = _HDR.size
        qverts = np.frombuffer(buf, np.uint16, V * 3, off).reshape(V, 3)
        off += V * 6
        vcolors = np.frombuffer(buf, np.uint8, V * 3, off).reshape(V, 3)
        off += V * 3
        fdtype = np.uint16 if V <= 0xFFFF else np.uint32
        faces = np.frombuffer(buf, fdtype, F * 3, off).reshape(
            F, 3).astype(np.uint32)
        off += F * 3 * fdtype().itemsize
        frame_runs = np.frombuffer(buf, np.uint16, F * P * 2,
                                   off).reshape(F, P, 2)
        off += F * P * 4
        kf_stamps = np.frombuffer(buf, np.float64, K, off)
        off += K * 8
        kf_poses = np.frombuffer(buf, np.float32, K * 7, off).reshape(K, 7)
        return MeshWithHistory(cid, csid, t0, t1,
                               np.array([ax, ay, az], np.float32), scale,
                               qverts.copy(), vcolors.copy(), faces.copy(),
                               frame_runs.copy(), kf_stamps.copy(),
                               kf_poses.copy())

    @property
    def nbytes(self) -> int:
        fb = 6 if self.qverts.shape[0] <= 0xFFFF else 12
        return (_HDR.size + self.qverts.shape[0] * 9
                + self.faces.shape[0] * (fb + 4 * self.frame_runs.shape[1])
                + self.kf_stamps.shape[0] * 36)

    def vertices(self) -> np.ndarray:
        """Dequantized submap-frame vertices (V,3) f32 (MeshConverter's
        uint16 decode, mesh_converter.h:93-110)."""
        return (self.qverts.astype(np.float32) * self.scale
                + self.aabb_min[None, :])


# ---------------------------------------------------------------------------
# Encode (sender side)
# ---------------------------------------------------------------------------


def _project_np(intr: PinholeIntrinsics, p_cam: np.ndarray):
    """Points in the camera frame (N,3) → (u, v, z, in_image)."""
    z = p_cam[:, 2]
    zs = np.maximum(z, 1e-6)
    u = p_cam[:, 0] / zs * intr.fx + intr.cx
    v = p_cam[:, 1] / zs * intr.fy + intr.cy
    ok = ((z > 0.05) & (u >= 0) & (u < intr.width) & (v >= 0)
          & (v < intr.height))
    return u, v, z, ok


def _visibility_runs(ok: np.ndarray, nidx: np.ndarray,
                     max_runs: int) -> np.ndarray:
    """Per-face in-frustum mask over keyframes (F,K) bool → run-length
    observation history (F, max_runs, 2) u16 [start,end] inclusive, the
    ``max_runs`` LONGEST runs per face (mesh_converter.h:137-142; extra
    runs are dropped longest-first). A face seen by no keyframe gets the
    degenerate run [nidx, nidx] (nearest keyframe)."""
    F, K = ok.shape
    runs = np.full((F, max_runs, 2), RUN_SENTINEL, np.uint16)
    if F == 0:
        return runs
    padded = np.zeros((F, K + 2), bool)
    padded[:, 1:-1] = ok
    d = np.diff(padded.astype(np.int8), axis=1)       # (F, K+1)
    f_s, k_s = np.nonzero(d == 1)                     # run starts
    f_e, k_e = np.nonzero(d == -1)                    # run ends (excl.)
    lengths = k_e - k_s
    order = np.lexsort((-lengths, f_s))
    f_o, s_o, e_o = f_s[order], k_s[order], k_e[order] - 1
    # rank of each run within its face (0 = longest)
    first = np.searchsorted(f_o, f_o)
    rank = np.arange(len(f_o)) - first
    keep = rank < max_runs
    runs[f_o[keep], rank[keep], 0] = s_o[keep]
    runs[f_o[keep], rank[keep], 1] = e_o[keep]
    unseen = ~ok.any(axis=1)
    runs[unseen, 0, 0] = nidx[unseen]
    runs[unseen, 0, 1] = nidx[unseen]
    return runs


def encode_submap_mesh(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                       hist_stamps, hist_poses, intr: PinholeIntrinsics,
                       client_id: int = 0, submap_id: int = 0,
                       keyframe_stride: int = 4, min_weight: float = 1e-4,
                       cluster_scale: float = 1.5, max_obs_runs: int = 2,
                       soup=None) -> MeshWithHistory:
    """Submap → MeshWithHistory: extract the mesh (or take ``soup``, a
    precomputed (verts (T,3,3), colors (T,3,3)) triangle soup such as an
    IncrementalMesher's), vertex-cluster it to ≈ cluster_scale·voxel,
    subsample the pose history into keyframes, and record every face's
    run-length observation history (tsdf_recover.h:119-136)."""
    if soup is not None:
        soup_v, soup_c = soup
    else:
        soup_v, soup_c = mesh_ops.extract_mesh(spec, layer,
                                               min_weight=min_weight)
    mesh = mesh_post.connect_soup(soup_v, soup_c)
    mesh = mesh_post.simplify_vertex_clustering(
        mesh, cluster_scale * spec.voxel_size)
    hist_stamps = np.asarray(hist_stamps, np.float64)
    hist_poses = np.asarray(hist_poses, np.float32)
    kf = np.arange(0, max(len(hist_stamps), 1), keyframe_stride)
    kf_stamps = hist_stamps[kf] if len(hist_stamps) else np.zeros((1,))
    kf_poses = (hist_poses[kf] if len(hist_poses)
                else geo.identity_np()[None].astype(np.float32))

    if mesh.n_vertices == 0:
        return MeshWithHistory(
            client_id, submap_id,
            float(kf_stamps[0]), float(kf_stamps[-1]),
            np.zeros(3, np.float32), spec.voxel_size / 64.0,
            np.zeros((0, 3), np.uint16), np.zeros((0, 3), np.uint8),
            np.zeros((0, 3), np.uint32),
            np.full((0, max_obs_runs, 2), RUN_SENTINEL, np.uint16),
            kf_stamps, kf_poses)

    centroids = mesh.vertices[mesh.faces].mean(axis=1)   # (F,3)
    # per-keyframe visibility of each face centroid, and the nearest
    # keyframe as the fallback for faces outside every frustum
    K = kf_poses.shape[0]
    ok_mat = np.zeros((centroids.shape[0], K), bool)
    nearest = np.full(centroids.shape[0], np.inf)
    nidx = np.zeros(centroids.shape[0], np.uint16)
    for k in range(K):
        p_cam = geo.transform_points_np(geo.inverse_np(kf_poses[k]),
                                        centroids)
        ok_mat[:, k] = _project_np(intr, p_cam)[3]
        d = np.linalg.norm(p_cam, axis=1)
        near_upd = d < nearest
        nearest[near_upd] = d[near_upd]
        nidx[near_upd] = k
    runs = _visibility_runs(ok_mat, nidx, max_obs_runs)

    aabb_min = mesh.vertices.min(axis=0)
    extent = mesh.vertices.max(axis=0) - aabb_min
    scale = max(float(extent.max()) / 65535.0, 1e-6)
    q = np.clip((mesh.vertices - aabb_min[None, :]) / scale, 0,
                65535).astype(np.uint16)
    c8 = (np.clip(mesh.colors * 255.0, 0, 255).astype(np.uint8)
          if mesh.colors is not None
          else np.zeros((mesh.n_vertices, 3), np.uint8))
    return MeshWithHistory(
        client_id, submap_id, float(kf_stamps[0]), float(kf_stamps[-1]),
        aabb_min.astype(np.float32), scale, q, c8,
        mesh.faces.astype(np.uint32), runs, kf_stamps, kf_poses)


# ---------------------------------------------------------------------------
# Decode (receiver side) — MeshConverter equivalent
# ---------------------------------------------------------------------------


def _bary_lattice(level: int) -> np.ndarray:
    """Barycentric lattice weights {(i, j, ℓ−i−j)/ℓ} of subdivision level
    ℓ: corners, edge points and interior → ((ℓ+1)(ℓ+2)/2, 3)."""
    pts = [(i, j, level - i - j) for i in range(level + 1)
           for j in range(level + 1 - i)]
    return np.asarray(pts, np.float64) / level


def decode_to_pointclouds(msg: MeshWithHistory,
                          interpolate_voxel_size: float = 0.05,
                          max_level: int = 4
                          ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """MeshWithHistory → {keyframe id: (sensor-frame points (N,3), colors
    (N,3) f32)}. Each triangle emits a barycentric lattice of points at ≈
    interpolate_voxel_size spacing with blended colours
    (interpolateTriangle, mesh_converter.h:211-265) into the cloud of
    EVERY keyframe its runs cover (mesh_converter.h:137-159), then each
    bucket goes into its keyframe's sensor frame (getNextPointcloud,
    :186-209)."""
    if msg.faces.shape[0] == 0:
        return {}
    tri_v = msg.vertices()[msg.faces]                    # (F,3,3)
    tri_c = (msg.vcolors.astype(np.float32) / 255.0)[msg.faces]
    edge = np.linalg.norm(
        tri_v - tri_v[:, [1, 2, 0], :], axis=-1).max(axis=1)   # (F,)
    level = np.clip(np.ceil(edge / max(interpolate_voxel_size, 1e-6)
                            ).astype(np.int64), 1, max_level)

    pts_parts, col_parts, fid_parts = [], [], []
    for lv in range(1, max_level + 1):
        sel = level == lv
        if not np.any(sel):
            continue
        w = _bary_lattice(lv)                            # (P,3)
        pts_parts.append(np.einsum("pk,tkd->tpd", w, tri_v[sel]
                                   ).reshape(-1, 3))
        col_parts.append(np.einsum("pk,tkd->tpd", w, tri_c[sel]
                                   ).reshape(-1, 3))
        fid_parts.append(np.repeat(np.nonzero(sel)[0], w.shape[0]))
    pts = np.concatenate(pts_parts).astype(np.float32)
    cls = np.concatenate(col_parts).astype(np.float32)
    fids = np.concatenate(fid_parts)

    runs = msg.frame_runs                                # (F,P,2)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in range(msg.kf_poses.shape[0]):
        face_sees_k = ((runs[:, :, 0] <= k)
                       & (k <= runs[:, :, 1])).any(axis=1)    # (F,)
        m = face_sees_k[fids]
        if not np.any(m):
            continue
        out[k] = (geo.transform_points_np(geo.inverse_np(msg.kf_poses[k]),
                                          pts[m]), cls[m])
    return out


# ---------------------------------------------------------------------------
# Recover (receiver side) — TsdfRecover equivalent
# ---------------------------------------------------------------------------


def render_points(intr: PinholeIntrinsics, pts_cam: Tensor, cols: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """Z-buffer point splat of sensor-frame points (N,3) with colours
    (N,3) → (depth (H,W), color (H,W,3)) on their device; 0 depth where no
    point lands. Each pixel takes the colour of its point of least z,
    then of lowest index. No host read."""
    H, W = intr.height, intr.width
    device = pts_cam.device
    z = pts_cam[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = torch.round(pts_cam[:, 0] / zs * intr.fx + intr.cx).to(torch.int32)
    v = torch.round(pts_cam[:, 1] / zs * intr.fy + intr.cy).to(torch.int32)
    ok = (z > 0.05) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    lin = torch.where(ok, v * W + torch.clamp(u, 0, W - 1), H * W).long()
    depth = torch.full((H * W + 1,), float("inf"), dtype=torch.float32,
                       device=device).scatter_reduce_(0, lin, z, "amin")
    nearest = ok & (z == depth[lin])
    n = z.shape[0]
    idx = torch.arange(n, device=device)
    win = torch.full((H * W + 1,), n, dtype=torch.int64,
                     device=device).scatter_reduce_(
        0, torch.where(nearest, lin, H * W), idx, "amin")[:H * W]
    color = torch.cat([cols, cols.new_zeros((1, 3))])[win]
    depth = depth[:H * W]
    depth = torch.where(torch.isfinite(depth), depth, 0.0)
    return depth.reshape(H, W), color.reshape(H, W, 3)


def recover_layer(spec: vx.VoxelGridSpec, cfg: tsdf_ops.TsdfIntegratorConfig,
                  intr: PinholeIntrinsics, msg: MeshWithHistory,
                  interpolate_voxel_size: Optional[float] = None,
                  method: str = "projective", use_const_weight: bool = True,
                  device=None) -> vx.TsdfLayer:
    """Rebuild a TSDF layer on ``device`` (None: the card) from a
    MeshWithHistory (TsdfRecover::processMesh, tsdf_recover.h:59-99).

    - "projective": per keyframe, splat the cloud into a virtual RGB-D
      frame (``render_points``) and run the projective integrator;
    - "merged": feed each keyframe cloud to the point-cloud integrator
      (ops/points.py): no virtual frame, no pinhole model.

    ``use_const_weight=True`` turns off 1/d² weighting, as the reference
    recover node does (use_const_weight: true, tsdf_recover.yaml:11):
    points decoded from a mesh have no sensor-noise model."""
    if method not in ("projective", "merged"):
        raise ValueError(f"unknown recover method {method!r}")
    device = runtime.require_cuda() if device is None else device
    space = (interpolate_voxel_size if interpolate_voxel_size is not None
             else spec.voxel_size)
    if use_const_weight:
        cfg = dataclasses.replace(cfg, use_distance_weight=False)
    clouds = decode_to_pointclouds(msg, interpolate_voxel_size=space)
    layer = vx.create_tsdf_layer(spec, device)
    pcfg = pts_ops.points_cfg_from(cfg)
    for k in sorted(clouds):
        pts = upload(clouds[k][0], device)
        cols = upload(clouds[k][1], device)
        pose = upload(msg.kf_poses[k], device)
        if method == "merged":
            pts_ops.integrate_points(
                spec, pcfg, layer, pts, cols,
                torch.ones((pts.shape[0],), dtype=torch.bool, device=device),
                pose)
        else:
            depth, color = render_points(intr, pts, cols)
            tsdf_ops.integrate_frame(spec, cfg, intr, layer, depth, color,
                                     pose)
    return layer
