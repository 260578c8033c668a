"""VIO adapter facade — port of ``coxgraph_tpu.frontends.vio_interface``,
the coxgraph_mod equivalent (vio_interface.h:17-140: updatePose,
publishLoopClosure, toggleMapping, needToFuse with its cache;
loop_closure_publisher.h routing; tf_publisher.h odometry out).

An odometry frontend (or the synthetic replay) feeds the robot
through it: pose updates → the robot's mapper step, loop closures →
``server.map_fusion`` (the server forwards same-robot ones back as local
constraints), and need-to-fuse answers are cached. Poses are host numpy
(7,) [q, t] or tensors; host poses keep the mapper's host mirror valid.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..mapper import submap_mapper as sm
from ..server.fusion_server import CoxgraphServer, MapFusionMsg
from ..utils.tensorops import host

# ORB-SLAM camera convention (z forward, y down) → ROS/world (x forward,
# z up) change of basis (tf_orb_to_ros, tf_publisher.h:187)
_ORB_TO_ROS = np.array([[0.0, 0.0, 1.0],
                        [-1.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0]])


def _pose_from_rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    q = geo.matrix_to_quat(torch.from_numpy(np.asarray(R, np.float32)))
    return geo.make(q, torch.from_numpy(np.asarray(t, np.float32))).numpy()


def pose_from_orbslam(T_cw: np.ndarray) -> np.ndarray:
    """ORB-SLAM tracker output T_cw (4×4 camera-from-world, ORB axes) →
    T_odom_cam (7,) f32 numpy in the world convention: rebase to ROS
    axes, invert to world-from-camera, rebase again
    (tf_publisher.h:184-205)."""
    T_cw = np.asarray(T_cw, np.float64)
    R = _ORB_TO_ROS @ T_cw[:3, :3]
    t = _ORB_TO_ROS @ T_cw[:3, 3]
    R = R.T
    t = -(R @ t)
    return _pose_from_rt(_ORB_TO_ROS @ R, _ORB_TO_ROS @ t)


class VIOInterface:
    def __init__(self, client_id: int, cfg: sm.MapperConfig,
                 client, server: Optional[CoxgraphServer] = None):
        """client: server.client_interface.InProcessClient of this robot;
        its state's device is the mapper's."""
        self.client_id = client_id
        self.cfg = cfg
        self.client = client
        self.server = server
        self.mapping_enabled = True
        self._need_to_fuse_cache: Dict[Tuple[int, int], bool] = {}
        self.T_odom_latest = None
        # optional IMU extrinsics chain T_odom_imu · T_imu_sensor
        # (tf_publisher.h:76-100)
        self.T_imu_sensor = None
        # host-side rollover clock: no device read in the frame loop
        self._mapper = sm.HostMapper(cfg, client.state)

    # vio_interface.h:34-44 updatePose — odometry in, mapping step out
    def update_pose(self, T_odom_cam, t: float, depth=None,
                    color=None) -> None:
        self.T_odom_latest = T_odom_cam
        if self.mapping_enabled and depth is not None:
            # the client's pause lock across the frame: with async PGO
            # the server's solve thread pushes pose updates concurrently
            # (submap_proc_mutex_, coxgraph_client.h:126)
            with self.client.lock:
                self._mapper.state = self.client.state
                self._mapper.step(depth, color, T_odom_cam, t)
                self.client.state = self._mapper.state
            if self.server is not None:
                self.server.time_line_update()

    # vio_interface.h:46-60 publishLoopClosure (both overloads)
    def publish_loop_closure(self, from_client: int, from_time: float,
                             to_client: int, to_time: float,
                             T_from_to) -> bool:
        if self.server is None:
            return False
        return self.server.map_fusion(MapFusionMsg(
            from_client=from_client, from_time=from_time,
            to_client=to_client, to_time=to_time, T_from_to=T_from_to))

    def update_pose_matrix(self, T_cw: np.ndarray, t: float, depth=None,
                           color=None, orbslam_axes: bool = True) -> None:
        """updatePose(cv::Mat / Eigen::Matrix4d) overload
        (vio_interface.h:34-44): the tracker's 4×4 camera-from-world
        matrix, optionally in ORB-SLAM axes."""
        if orbslam_axes:
            T = pose_from_orbslam(T_cw)
        else:
            T4 = np.asarray(T_cw, np.float64)
            T = _pose_from_rt(T4[:3, :3], T4[:3, 3])
        self.update_pose(T, t, depth, color)

    def frames(self):
        """The current transform chain, the pull form of the reference's
        odom→imu→sensor TF broadcast (tf_publisher.h:76-100):
        {('odom','sensor'): T} or, with IMU extrinsics set,
        {('odom','imu'): T·T_I_S⁻¹, ('imu','sensor'): T_I_S}; host numpy
        poses."""
        if self.T_odom_latest is None:
            return {}
        T_O_S = host(self.T_odom_latest)
        if self.T_imu_sensor is None:
            return {("odom", "sensor"): T_O_S}
        T_I_S = host(self.T_imu_sensor)
        return {("odom", "imu"): geo.compose_np(T_O_S,
                                                geo.inverse_np(T_I_S)),
                ("imu", "sensor"): T_I_S}

    # vio_interface.h:68-80 toggleMapping service
    def toggle_mapping(self, enable: bool) -> None:
        self.mapping_enabled = enable

    # vio_interface.h:82-113 needToFuse with its cache + updateNeedToFuse
    def need_to_fuse(self, cid_a: int, cid_b: int, t: float) -> bool:
        key = (min(cid_a, cid_b), max(cid_a, cid_b))
        if self.server is not None:
            self._need_to_fuse_cache[key] = self.server.need_to_fuse(
                cid_a, cid_b, t)
        return self._need_to_fuse_cache.get(key, True)
