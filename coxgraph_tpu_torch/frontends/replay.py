"""Dataset replay and scripted experiments — port of
``coxgraph_tpu.frontends.replay``, the stand-in for the reference's
rosbag-replay harness (corb_frontend_cvg.launch:46-51, including the
time-shifted second replay of one bag as a second robot) and the
TUM-RGBD input path.

  * ``SyntheticReplay`` renders the analytic scene along a trajectory on
    the scene's device, optionally with drifting odometry;
  * ``TumRgbdReplay`` streams a TUM-RGBD directory (rgb.txt, depth.txt,
    groundtruth.txt and PNG frames), decoded by ``read_png`` (zlib and
    numpy: no image library is needed);
  * ``time_shifted`` re-bases a stream in time;
  * ``two_robot_experiment`` builds the CVG two-client experiment;
  * ``OdometryTransformer`` moves ground-truth odometry into a robot's
    odom frame (host numpy).

Frames carry their images as tensors on the device and their poses as
host numpy, so a ``HostMapper`` keeps its host mirror. The odometry
noise is drawn from a torch generator seeded with ``seed``
(``synthetic.odometry_noise``); ``odometry_noise`` replaces the draw (the
tests feed the JAX package's).
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import zlib
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from .. import runtime
from ..core import geometry as geo
from . import synthetic as syn

Tensor = torch.Tensor


class Frame(NamedTuple):
    t: float
    depth: Tensor              # (H,W) z-depth, 0 invalid
    color: Optional[Tensor]    # (H,W,3) in [0,1]
    T_world_cam: np.ndarray    # ground truth (for evaluation)
    T_odom_cam: np.ndarray     # odometry estimate (the mapper's input)


# ---------------------------------------------------------------------------
# PNG decoding (non-interlaced 8-bit RGB / RGBA / grey and 16-bit grey)
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # colour type → samples per pixel


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None, Sub, Up, Average, Paeth)
    → (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 2:
            cur = line + prev                       # uint8 wraps mod 256
        elif ftype == 1:
            # Sub: a running sum along the row per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced PNG of bit depth 8 (grey, grey+alpha, RGB,
    RGBA) or 16 (any of those) → (H,W) or (H,W,C) uint8 / uint16, the
    array PIL's ``np.asarray(Image.open(path))`` gives for these files."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    off, idat, hdr = 8, [], None
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        kind = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if interlace or depth not in (8, 16) or ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    nbytes = depth // 8
    bpp = ch * nbytes
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                    bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


# ---------------------------------------------------------------------------
# Replays
# ---------------------------------------------------------------------------


def _np_pose(T) -> np.ndarray:
    return np.asarray(T.cpu() if isinstance(T, Tensor) else T, np.float32)


@dataclasses.dataclass
class SyntheticReplay:
    scene: syn.Scene
    intr: syn.PinholeIntrinsics
    trajectory: np.ndarray                 # (N,7) ground truth
    dt: float = 0.05                       # 20 Hz (BASELINE.md)
    odom_rot_std: float = 0.0
    odom_trans_std: float = 0.0
    T_world_odom: Optional[np.ndarray] = None   # odom-frame offset
    seed: int = 0
    odometry_noise: Optional[np.ndarray] = None  # (N-1,6) replaces the draw

    def odometry(self) -> np.ndarray:
        """The odometry poses (N,7) in the world frame (host numpy)."""
        traj = torch.from_numpy(_np_pose(self.trajectory))
        noise = self.odometry_noise
        if noise is None:
            if self.odom_rot_std <= 0 and self.odom_trans_std <= 0:
                return traj.numpy()
            noise = syn.odometry_noise(
                torch.Generator().manual_seed(self.seed), traj.shape[0] - 1,
                self.odom_rot_std, self.odom_trans_std)
        return syn.compose_odometry(
            traj, torch.as_tensor(np.asarray(noise, np.float32))).numpy()

    def __iter__(self) -> Iterator[Frame]:
        traj = _np_pose(self.trajectory)
        odom = self.odometry()
        X_inv = (geo.inverse_np(_np_pose(self.T_world_odom))
                 if self.T_world_odom is not None else None)
        device = self.scene.spheres.device
        for i in range(traj.shape[0]):
            depth, color = syn.render_depth(
                self.scene, self.intr, torch.from_numpy(traj[i]).to(device))
            T_odom = (odom[i] if X_inv is None
                      else geo.compose_np(X_inv, odom[i]))
            yield Frame(t=i * self.dt, depth=depth, color=color,
                        T_world_cam=traj[i],
                        T_odom_cam=np.asarray(T_odom, np.float32))


def time_shifted(frames, shift: float):
    """Re-base a frame stream in time (the second robot from the same bag,
    corb_frontend_cvg.launch:48-51)."""
    for f in frames:
        yield f._replace(t=f.t + shift)


@dataclasses.dataclass
class TumRgbdReplay:
    """TUM-RGBD directory replay (rgb.txt, depth.txt, groundtruth.txt).

    Depth PNGs are 16-bit, millimetre-scaled by ``depth_factor`` (5000).
    Frames go to ``device`` (None: the card). ``rebase_time`` moves stamps
    to start near 0 (``t0`` = the first served frame's stamp): epoch
    stamps (~1.3e9 s) in f32 device arrays quantize to ~128 s."""

    root: str
    intr: syn.PinholeIntrinsics = syn.PinholeIntrinsics()
    depth_factor: float = 5000.0
    max_frames: Optional[int] = None
    rebase_time: bool = True
    t0: float = 0.0
    device: Optional[torch.device] = None

    def _read_list(self, name):
        rows = []
        with open(os.path.join(self.root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                rows.append((float(parts[0]), parts[1:]))
        return rows

    def __iter__(self) -> Iterator[Frame]:
        device = (runtime.require_cuda() if self.device is None
                  else self.device)
        rgb = self._read_list("rgb.txt")
        dep = self._read_list("depth.txt")
        gt = self._read_list("groundtruth.txt")
        gt_t = np.array([t for t, _ in gt])
        gt_p = np.array([[float(x) for x in v] for _, v in gt])  # tx..qw
        dep_t = np.array([t for t, _ in dep])
        if self.rebase_time and rgb:
            self.t0 = rgb[0][0]
        n = 0
        for t, (rgb_path,) in rgb:
            if self.max_frames is not None and n >= self.max_frames:
                break
            j = int(np.argmin(np.abs(dep_t - t)))
            if abs(dep_t[j] - t) > 0.03:
                continue
            k = int(np.clip(np.searchsorted(gt_t, t), 1, len(gt_t) - 1))
            tx, ty, tz, qx, qy, qz, qw = gt_p[k]
            T = np.array([qw, qx, qy, qz, tx, ty, tz], np.float32)
            depth = np.asarray(read_png(os.path.join(self.root,
                                                     dep[j][1][0])),
                               np.float32) / self.depth_factor
            color = np.asarray(read_png(os.path.join(self.root, rgb_path)),
                               np.float32)[..., :3] / 255.0
            yield Frame(t=t - self.t0,
                        depth=torch.from_numpy(depth).to(device),
                        color=torch.from_numpy(color).to(device),
                        T_world_cam=T, T_odom_cam=T)
            n += 1


def two_robot_experiment(scene: Optional[syn.Scene] = None,
                         n_frames: int = 40,
                         intr: Optional[syn.PinholeIntrinsics] = None,
                         dt: float = 0.05, drift: bool = True, device=None):
    """The CVG two-client experiment: two overlapping sweeps with distinct
    odom frames → ([SyntheticReplay] × 2, trajectories [(N,7)] × 2, odom
    frame offsets X [(7,)] × 2), poses as host numpy. Frames render on
    ``scene``'s device (default: the analytic scene on ``device``, None:
    the card); the trajectories are computed on the host, robot r's
    odometry noise drawn with seed r."""
    if scene is None:
        scene = syn.default_scene(runtime.require_cuda() if device is None
                                  else device)
    intr = intr or syn.PinholeIntrinsics().scaled(0.25)
    center = scene.room_center.cpu()
    trajs = [syn.orbit_trajectory(n_frames, center, radius=2.4,
                                  sweep=1.2 * math.pi,
                                  start_angle=a).numpy()
             for a in (0.0, math.pi)]
    X = [geo.identity_np(),
         geo.from_xyzyaw(torch.tensor([0.8, -0.4, 0.0, 0.5])).numpy()]
    return [
        SyntheticReplay(
            scene=scene, intr=intr, trajectory=trajs[r], dt=dt,
            odom_rot_std=0.002 if drift else 0.0,
            odom_trans_std=0.005 if drift else 0.0,
            T_world_odom=X[r], seed=r)
        for r in range(2)
    ], trajs, X


class OdometryTransformer:
    """Ground-truth world-frame odometry → a robot's odom frame with a
    configurable origin (the coxgraph_sim OdometryTransformPublisher,
    odometry_transform_publisher.cpp:30-110): T_O_B = T_G_O⁻¹·T_G_B with
    T_G_O from the origin parameters (:30-43), the twist re-expressed
    through R_G_O⁻¹ (:74-91). Host numpy. ``frames()`` is the pull form of
    its odom→base TF timer (:102-110)."""

    def __init__(self, origin_xyz=(0.0, 0.0, 0.0), origin_yaw: float = 0.0,
                 odom_frame: str = "odom", base_frame: str = "base_link"):
        half = 0.5 * float(origin_yaw)
        q = np.array([np.cos(half), 0.0, 0.0, np.sin(half)], np.float32)
        self.T_G_O = np.concatenate(
            [q, np.asarray(origin_xyz, np.float32)])
        self.odom_frame = odom_frame
        self.base_frame = base_frame
        self.T_O_B: Optional[np.ndarray] = None

    def transform(self, T_G_B, lin_vel=None, ang_vel=None):
        """One ground-truth odometry sample → (T_O_B[, lin_vel_O,
        ang_vel_O]) in this robot's odom frame (odomCallback, :60-98)."""
        self.T_O_B = geo.compose_np(geo.inverse_np(self.T_G_O),
                                    _np_pose(T_G_B))
        if lin_vel is None and ang_vel is None:
            return self.T_O_B
        q_inv = self.T_G_O[:4] * np.array([1, -1, -1, -1], np.float32)
        out = [self.T_O_B]
        for v in (lin_vel, ang_vel):
            out.append(None if v is None else geo._np_quat_rotate(
                q_inv, np.asarray(v, np.float32)))
        return tuple(out)

    def frames(self):
        """{(odom_frame, base_frame): latest T_O_B} (publishTf,
        :103-110)."""
        if self.T_O_B is None:
            return {}
        return {(self.odom_frame, self.base_frame): self.T_O_B}
