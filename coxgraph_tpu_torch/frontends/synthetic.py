"""Synthetic RGB-D scene rendering — port of
``coxgraph_tpu.frontends.synthetic``.

Scene = room box (inverted AABB) ∪ spheres ∪ boxes, rendered by sphere
tracing its analytic SDF. ``scene_sdf`` doubles as ground truth for the
TSDF accuracy checks. The port renders its own frames on the device it is
given, so a GPU run needs no clip made by the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import geometry as geo
from ..utils.tensorops import f32_reciprocal

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PinholeIntrinsics:
    """Static camera model: z forward, x right, y down."""

    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5

    def scaled(self, s: float) -> "PinholeIntrinsics":
        return PinholeIntrinsics(
            width=int(self.width * s), height=int(self.height * s),
            fx=self.fx * s, fy=self.fy * s,
            cx=(self.cx + 0.5) * s - 0.5, cy=(self.cy + 0.5) * s - 0.5,
        )


@dataclasses.dataclass
class Scene:
    """Analytic scene: spheres (N,4)=[cx,cy,cz,r], boxes (M,6)=[min,max],
    room half-extent (3,) — walls of an axis-aligned room centered at
    room_center."""

    spheres: Tensor
    boxes: Tensor
    room_center: Tensor
    room_half: Tensor


def default_scene(device) -> Scene:
    """A 10×8×3 m room with a few obstacles (the JAX package's scene)."""
    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return Scene(
        spheres=t([[1.5, 1.0, 0.8, 0.8],
                   [-2.0, -1.5, 0.6, 0.6],
                   [0.5, -2.0, 1.8, 0.4]]),
        boxes=t([[-0.6, 2.0, 0.0, 0.6, 3.2, 1.2],
                 [2.8, -2.8, 0.0, 3.6, -1.6, 2.0]]),
        room_center=t([0.0, 0.0, 1.5]),
        room_half=t([5.0, 4.0, 1.5]),
    )


def scene_sdf(scene: Scene, p: Tensor) -> Tensor:
    """Signed distance of the scene at points (...,3). Negative inside
    solids; the room interior is free space bounded by walls."""
    sdf = torch.min(scene.room_half - torch.abs(p - scene.room_center),
                    dim=-1).values
    pe = p[..., None, :]
    s = scene.spheres
    sph = torch.linalg.norm(pe - s[:, :3], dim=-1) - s[:, 3]   # (..., N)
    sdf = torch.minimum(sdf, torch.min(sph, dim=-1).values)
    b = scene.boxes
    c = 0.5 * (b[:, :3] + b[:, 3:])
    h = 0.5 * (b[:, 3:] - b[:, :3])
    q = torch.abs(pe - c) - h                                  # (..., M, 3)
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
    box = outside + inside
    return torch.minimum(sdf, torch.min(box, dim=-1).values)


def _ray_dirs(intr: PinholeIntrinsics, device) -> Tensor:
    """Unit ray directions in camera frame, (H, W, 3)."""
    u = torch.arange(intr.width, dtype=torch.float32, device=device)
    v = torch.arange(intr.height, dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")               # (H, W)
    d = torch.stack([(uu - intr.cx) * f32_reciprocal(intr.fx),
                     (vv - intr.cy) * f32_reciprocal(intr.fy),
                     torch.ones_like(uu)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def render_depth(scene: Scene, intr: PinholeIntrinsics, T_world_cam: Tensor,
                 max_range: float = 10.0, n_steps: int = 96):
    """Sphere-trace a depth + color frame on T_world_cam's device.

    Returns (depth (H,W) — z-depth along the optical axis, 0 where no hit;
    color (H,W,3) in [0,1])."""
    device = T_world_cam.device
    dirs_cam = _ray_dirs(intr, device)
    R = geo.quat_to_matrix(geo.rotation(T_world_cam))
    origin = geo.translation(T_world_cam)
    dirs = torch.einsum("ij,hwj->hwi", R, dirs_cam)

    t = torch.zeros(dirs.shape[:2], dtype=torch.float32, device=device)
    hit = torch.zeros(dirs.shape[:2], dtype=torch.bool, device=device)
    for _ in range(n_steps):
        d = scene_sdf(scene, origin + t[..., None] * dirs)
        hit = hit | (d < 1e-3)
        t = torch.where(hit, t, torch.clamp(t + torch.clamp(d, min=1e-3),
                                            max=max_range))

    # z-depth (projective) = range * cos(angle to optical axis)
    depth = torch.where(hit, t * dirs_cam[..., 2], 0.0)

    # normal-based shading for color
    p = origin + t[..., None] * dirs
    eps = 1e-3
    offs = torch.eye(3, dtype=torch.float32, device=device) * eps
    n = torch.stack([scene_sdf(scene, p + off) - scene_sdf(scene, p - off)
                     for off in offs], dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-6)
    shade = 0.5 + 0.5 * torch.abs(n)

    # viewpoint-invariant procedural texture (a function of the 3D point)
    def checker(q, s):
        c = torch.floor(q * f32_reciprocal(s))
        return torch.remainder(c[..., 0] + c[..., 1] + c[..., 2], 2.0)

    tex = (0.45
           + 0.22 * checker(p, 0.31)
           + 0.16 * checker(p + 0.123, 0.53)
           + 0.12 * torch.sin(9.1 * p[..., 0]) * torch.sin(7.3 * p[..., 1]))
    color = torch.where(hit[..., None], shade * tex[..., None], 0.0)
    return depth, color


def orbit_trajectory(n_frames: int, center: Tensor, radius: float = 3.0,
                     height: float = 0.0, sweep: float = 2.0 * math.pi,
                     start_angle: float = 0.0) -> Tensor:
    """Camera poses (n,7) orbiting ``center``, optical axis aimed at it
    (the ground-truth trajectory for tests and the bench clip)."""
    device = center.device
    # jnp.linspace(0, sweep, n, endpoint=False) in its own f32 arithmetic
    step = torch.arange(n_frames, dtype=torch.float32,
                        device=device) * f32_reciprocal(n_frames)
    sweep_t = torch.tensor(sweep, dtype=torch.float32, device=device)
    a = start_angle + (0.0 * (1 - step) + sweep_t * step)

    eye = torch.stack([center[0] + radius * torch.cos(a),
                       center[1] + radius * torch.sin(a),
                       center[2] + torch.full_like(a, 0.0 + height)],
                      dim=-1)
    fwd = center - eye
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    up_w = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32, device=device)
    right = torch.linalg.cross(fwd, up_w.expand_as(fwd), dim=-1)
    right = right / torch.clamp(torch.linalg.norm(right, dim=-1,
                                                  keepdim=True), min=1e-6)
    down = torch.linalg.cross(fwd, right, dim=-1)
    R = torch.stack([right, down, fwd], dim=-1)  # columns = cam axes
    return geo.make(geo.matrix_to_quat(R), eye)


def odometry_noise(generator: torch.Generator, n_steps: int,
                   rot_std: float = 0.002, trans_std: float = 0.005
                   ) -> Tensor:
    """Per-step odometry noise (n_steps, 6) [rotation, translation] drawn
    from ``generator`` on its own device. ``jax.random`` has no torch
    twin, so the draw is kept apart from ``compose_odometry``: the tests
    feed the JAX package's draw to that half."""
    z = torch.randn((n_steps, 6), generator=generator,
                    device=generator.device)
    return torch.cat([z[:, :3] * rot_std, z[:, 3:] * trans_std], dim=1)


def compose_odometry(poses: Tensor, noise: Tensor) -> Tensor:
    """Integrate the ground truth's relative motions, each perturbed by
    ``se3_exp`` of its noise row, from ``poses[0]`` → drifting odometry
    (n, 7) (the deterministic half of ``noisy_odometry``)."""
    rels = geo.relative(poses[:-1], poses[1:])
    noisy = geo.compose(rels, geo.se3_exp(noise.to(poses.dtype)))
    out = [poses[0]]
    for k in range(noisy.shape[0]):
        out.append(geo.compose(out[-1], noisy[k]))
    return torch.stack(out)


def noisy_odometry(generator: torch.Generator, poses: Tensor,
                   rot_std: float = 0.002, trans_std: float = 0.005
                   ) -> Tensor:
    """Integrate ground-truth relative motions with per-step noise →
    drifting odometry (stand-in for the reference's external VIO
    frontend). Same model as the JAX package's; the random stream is
    torch's, so the noise differs draw by draw."""
    noise = odometry_noise(generator, poses.shape[0] - 1, rot_std,
                           trans_std)
    return compose_odometry(poses, noise.to(poses.device))
