"""Client-side merged-map server — port of
``coxgraph_tpu.mapper.map_server`` (the reference MapServer,
coxgraph/include/coxgraph/client/map_server.h:26-162,
src/client/map_server.cpp:12-152).

It keeps a merged odom-frame TSDF of all submaps, rebuilt after submap
pose changes (``updatePastTsdf``, map_server.cpp:59-73), a batch ESDF of
it (map_server.h:141-145), the traversability point set (free space with
robot-radius clearance, map_server.cpp:109-117) and the keyframe-filtered
trajectory of a submap (map_server.cpp:119-152). No topics or timers:
the merged maps are cached device tensors invalidated by pose updates
and rollovers, and queries return them. ``submap_mesh_msg`` encodes a
finished submap for the mesh-with-history transport.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import voxel as vx
from ..ops import esdf as esdf_ops
from . import submap_mapper as sm


@dataclasses.dataclass(frozen=True)
class MapServerConfig:
    """The reference's config block (map_server.h:26-60)."""

    esdf: esdf_ops.EsdfConfig = esdf_ops.EsdfConfig()
    robot_radius: float = 0.5          # m clearance for traversability
    keyframe_stride: int = 4           # fallback mesh-history subsample
    keyframe_tolerance: float = 0.025  # s stamp match (half a 20 Hz frame)


class MapServer:
    """Merged-map queries over a mapper's SubmapCollection with caching.
    Pull API: callers ask for the merged TSDF / ESDF / traversability when
    they need it; ``notify_pose_update()`` (the map-pose-updates
    subscription) invalidates the cache."""

    def __init__(self, cfg: sm.MapperConfig,
                 ms_cfg: MapServerConfig = MapServerConfig()):
        self.cfg = cfg
        self.ms_cfg = ms_cfg
        self._tsdf: Optional[vx.TsdfLayer] = None
        self._esdf: Optional[esdf_ops.EsdfLayer] = None
        self._built_for: int = -1       # num_submaps the cache was built at
        self._dirty: bool = True
        self._keyframe_stamps: list = []

    def notify_pose_update(self) -> None:
        """Submap poses changed (local PGO / server push): rebuild the
        merged maps on the next query (map_server.cpp:59-73)."""
        self._dirty = True

    def _refresh(self, col: sm.SubmapCollection) -> None:
        n = int(col.num_submaps)
        if not self._dirty and n == self._built_for and self._tsdf is not None:
            return
        self._tsdf = sm.merged_layer(self.cfg, col)
        self._esdf = None               # rebuilt lazily from the new TSDF
        self._built_for = n
        self._dirty = False

    def merged_tsdf(self, col: sm.SubmapCollection) -> vx.TsdfLayer:
        """Odom-frame merged TSDF of all submaps (updatePastTsdf)."""
        self._refresh(col)
        return self._tsdf

    def merged_esdf(self, col: sm.SubmapCollection) -> esdf_ops.EsdfLayer:
        """Batch ESDF of the merged TSDF (updateEsdfBatch,
        map_server.h:141-145)."""
        self._refresh(col)
        if self._esdf is None:
            self._esdf = esdf_ops.esdf_from_tsdf(
                self.cfg.spec, self._tsdf, self.ms_cfg.esdf)
        return self._esdf

    def traversability(self, col: sm.SubmapCollection
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Free-space voxel centres with > robot_radius clearance →
        (points (N,3), mask (N,)) on the device (map_server.cpp:109-117)."""
        esdf = self.merged_esdf(col)
        return esdf_ops.traversable_points(
            self.cfg.spec, esdf, self.ms_cfg.robot_radius)

    def add_keyframe(self, stamp: float) -> None:
        """Register a VIO keyframe stamp (the `keyframe_pose` topic,
        map_server.h:149-156)."""
        self._keyframe_stamps.append(float(stamp))

    def keyframe_history(self, col: sm.SubmapCollection, k: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Submap k's pose history filtered to the registered keyframes
        (publishSubmapMesh's filter, map_server.cpp:119-152), or a stride
        subsample when none are registered → host (stamps, poses). One
        device read."""
        kk = torch.full((1,), k, dtype=torch.long,
                        device=col.hist_count.device)
        H = col.hist_stamps.shape[1]
        row = torch.cat([col.hist_count.index_select(0, kk).to(torch.float32),
                         col.hist_stamps.index_select(0, kk).reshape(-1),
                         col.hist_poses.index_select(0, kk).reshape(-1)]
                        ).cpu().numpy()
        h = int(row[0])
        stamps = row[1:1 + H][:h].astype(np.float64)
        poses = row[1 + H:].reshape(H, 7)[:h].astype(np.float32)
        if not self._keyframe_stamps:
            sel = np.arange(0, h, max(1, self.ms_cfg.keyframe_stride))
        else:
            kf = np.asarray(self._keyframe_stamps, np.float64)
            d = np.abs(stamps[:, None] - kf[None, :])
            sel = np.nonzero(
                d.min(axis=1) <= self.ms_cfg.keyframe_tolerance)[0]
        return stamps[sel], poses[sel]

    def submap_mesh_msg(self, col: sm.SubmapCollection, k: int, intr,
                        client_id: int = 0, soup=None):
        """Finished submap k as a MeshWithHistory wire message with its
        keyframe-filtered trajectory (the reference's
        submap_mesh_with_traj output, map_server.cpp:119-152).

        ``soup``: a precomputed triangle soup (e.g.
        ``HostMapper.live_mesh(k)``), which skips the full-layer
        re-extraction."""
        from ..comm import mesh_comm

        stamps, poses = self.keyframe_history(col, k)
        return mesh_comm.encode_submap_mesh(
            self.cfg.spec, sm.get_layer(col.layers, k), stamps, poses, intr,
            client_id=client_id, submap_id=k,
            keyframe_stride=1,   # already keyframe-filtered above
            soup=soup)
