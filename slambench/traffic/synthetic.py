"""The benchmark's RGB-D traffic: a frozen, plain-PyTorch copy of the
port's synthetic room (``frontends.synthetic``: scene, sphere-traced
renderer, orbit trajectories, drifting odometry) with the Kinect depth
model of ``tests/make_real_fixture.py`` added. It lives here so that a
change to the port cannot move the yardstick.

Every draw comes from the run's seed: the orbit's start angle, the depth
noise (a ``torch.Generator`` on the rendering device) and the odometry
noise (numpy, float64). The work a seed gives is the same for every seed:
an orbit of fixed radius covers the same views in another order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..reference import geometry as geo

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5

    @staticmethod
    def of(cfg: dict) -> "Camera":
        return Camera(*(cfg["camera"][k] for k in
                        ("width", "height", "fx", "fy", "cx", "cy")))


@dataclasses.dataclass
class Scene:
    spheres: Tensor      # (N, 4) centre, radius
    boxes: Tensor        # (M, 6) min, max
    room_center: Tensor  # (3,)
    room_half: Tensor    # (3,)


def default_room(device) -> Scene:
    """The 10 × 8 × 3 m room with three spheres and two boxes."""
    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return Scene(spheres=t([[1.5, 1.0, 0.8, 0.8], [-2.0, -1.5, 0.6, 0.6],
                            [0.5, -2.0, 1.8, 0.4]]),
                 boxes=t([[-0.6, 2.0, 0.0, 0.6, 3.2, 1.2],
                          [2.8, -2.8, 0.0, 3.6, -1.6, 2.0]]),
                 room_center=t([0.0, 0.0, 1.5]),
                 room_half=t([5.0, 4.0, 1.5]))


def scene_sdf(s: Scene, p: Tensor) -> Tensor:
    d = torch.min(s.room_half - torch.abs(p - s.room_center), dim=-1).values
    pe = p[..., None, :]
    sph = torch.linalg.norm(pe - s.spheres[:, :3], dim=-1) - s.spheres[:, 3]
    d = torch.minimum(d, sph.min(dim=-1).values)
    c = 0.5 * (s.boxes[:, :3] + s.boxes[:, 3:])
    h = 0.5 * (s.boxes[:, 3:] - s.boxes[:, :3])
    q = torch.abs(pe - c) - h
    box = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
           + torch.clamp(q.max(dim=-1).values, max=0.0))
    return torch.minimum(d, box.min(dim=-1).values)


def render(scene: Scene, cam: Camera, T_world_cam: Tensor,
           max_range: float = 10.0, n_steps: int = 96):
    """Sphere-trace poses (B, 7) on their device → (z-depth (B, H, W), 0
    where nothing is hit; colour (B, H, W, 3) in [0, 1]; |cos| of the
    incidence angle (B, H, W))."""
    dev = T_world_cam.device
    u = torch.arange(cam.width, dtype=torch.float32, device=dev)
    v = torch.arange(cam.height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy,
                     torch.ones_like(uu)], dim=-1)
    dirs_cam = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    R = geo.quat_to_matrix(T_world_cam[:, :4])
    origin = T_world_cam[:, None, None, 4:7]
    dirs = torch.einsum("bij,hwj->bhwi", R, dirs_cam)
    t = torch.zeros(dirs.shape[:3], device=dev)
    hit = torch.zeros(dirs.shape[:3], dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        dist = scene_sdf(scene, origin + t[..., None] * dirs)
        hit = hit | (dist < 1e-3)
        t = torch.where(hit, t, torch.clamp(t + torch.clamp(dist, min=1e-3),
                                            max=max_range))
    depth = torch.where(hit, t * dirs_cam[..., 2], 0.0)
    p = origin + t[..., None] * dirs
    offs = torch.eye(3, device=dev) * 1e-3
    n = torch.stack([scene_sdf(scene, p + o) - scene_sdf(scene, p - o)
                     for o in offs], dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-6)
    cosang = torch.abs(torch.sum(n * dirs, dim=-1))

    def checker(q, s):
        c = torch.floor(q / s)
        return torch.remainder(c[..., 0] + c[..., 1] + c[..., 2], 2.0)

    tex = (0.45 + 0.22 * checker(p, 0.31) + 0.16 * checker(p + 0.123, 0.53)
           + 0.12 * torch.sin(9.1 * p[..., 0]) * torch.sin(7.3 * p[..., 1]))
    color = torch.where(hit[..., None],
                        (0.5 + 0.5 * torch.abs(n)) * tex[..., None], 0.0)
    return depth, color, cosang


def kinect_depth(depth: Tensor, cosang: Tensor, gen: torch.Generator,
                 noise: dict) -> Tensor:
    """The Kinect model (Khoshelham & Elberink): axial σ(z) = a + b·(z −
    z0)², dropout at grazing incidence and as random speckle holes, then
    TUM's 16-bit quantisation at ``factor`` steps a metre."""
    sigma = noise["sigma_a"] + noise["sigma_b"] * torch.square(
        torch.clamp(depth - noise["sigma_z0"], min=0.0))
    z = torch.randn(depth.shape, generator=gen, device=depth.device)
    holes = torch.rand(depth.shape, generator=gen, device=depth.device)
    d = depth + z * sigma
    keep = ((depth > 0) & (cosang >= noise["grazing_cos"])
            & (holes >= noise["speckle_holes"]))
    q = torch.floor(torch.clamp(torch.where(keep, d, 0.0) * noise["factor"],
                                0.0, 65535.0))
    return q * torch.tensor(1.0 / noise["factor"], dtype=torch.float32)


def orbit(n: int, center: np.ndarray, radius: float, height: float,
          start_angle: float, sweep: float = 2 * math.pi) -> np.ndarray:
    """Camera poses (n, 7) float64 on a circle about ``center``, each
    looking at it (x right, y down, z forward)."""
    a = start_angle + sweep * np.arange(n) / n
    eye = np.stack([center[0] + radius * np.cos(a),
                    center[1] + radius * np.sin(a),
                    np.full(n, center[2] + height)], -1)
    fwd = center[None] - eye
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    right = np.cross(fwd, np.array([0.0, 0.0, -1.0])[None])
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=-1)
    q = geo.matrix_to_quat(torch.from_numpy(R)).numpy()
    return np.concatenate([q, eye], -1)


def drifting_odometry(gt: np.ndarray, rng: np.random.Generator,
                      odo: dict, start: np.ndarray = None) -> np.ndarray:
    """Odometry (n, 7) float64: the ground truth's frame-to-frame motions,
    each perturbed by exp of a drawn tangent (σ_rot, σ_trans, with a
    roll and a z bias), chained from ``start`` (default gt[0])."""
    n = gt.shape[0]
    M = geo.np_to_matrix(gt)
    rel = np.linalg.inv(M[:-1]) @ M[1:]
    xi = np.concatenate([rng.normal(0, odo["rot_std"], (n - 1, 3)),
                         rng.normal(0, odo["trans_std"], (n - 1, 3))], -1)
    xi[:, 0] += odo["roll_bias"]
    xi[:, 5] += odo["z_bias"]
    steps = rel @ geo.np_exp_matrix(xi)
    out = np.empty_like(M)
    out[0] = M[0] if start is None else geo.np_to_matrix(start)
    for k in range(n - 1):
        out[k + 1] = out[k] @ steps[k]
    return geo.np_from_matrix(out)


def colour_u8(color: Tensor) -> Tensor:
    """Colour in [0, 1] as the sensor's 8-bit channels."""
    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)


def colour_f32(c8: Tensor) -> Tensor:
    """8-bit channels as the float colour both sides integrate."""
    return c8.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                               dtype=torch.float32)


def render_lap(scene: Scene, cam: Camera, poses: np.ndarray, gen, noise,
               device, batch: int = 30):
    """Render poses (n, 7) in batches → (depth (n, H, W) f32 with sensor
    noise, colour (n, H, W, 3) uint8), both on ``device``."""
    deps, cols = [], []
    T = torch.from_numpy(poses.astype(np.float32)).to(device)
    for i in range(0, T.shape[0], batch):
        d, c, cos = render(scene, cam, T[i:i + batch])
        deps.append(kinect_depth(d, cos, gen, noise))
        cols.append(colour_u8(c))
    return torch.cat(deps), torch.cat(cols)
