"""SE(3) geometry on torch tensors — port of ``coxgraph_tpu.core.geometry``.

A transform is a flat ``(..., 7)`` float tensor ``[qw, qx, qy, qz, tx, ty,
tz]``: Hamilton quaternion, scalar first, then translation. ``T_A_B`` maps
points from frame B to frame A: ``p_A = R(q) p_B + t``.

Every elementwise expression keeps the JAX reference's operation order,
and the cross product is written out as separate multiplies and
subtractions: a fused multiply-add would round differently, and the
projective TSDF update (``ops.cuda_tsdf``) matches this module bit for bit
on the card.

The ``*_np`` functions are NumPy twins for host-side bookkeeping (the
HostMapper pose mirror).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_EPS = 1e-8


def identity(device, dtype=torch.float32) -> Tensor:
    """The identity transform as a (7,) tensor on ``device``, built there
    by fills (a tensor from a host list, or an item assignment, would be
    a blocking copy)."""
    T = torch.zeros(7, dtype=dtype, device=device)
    T[:1].fill_(1.0)
    return T


def make(q: Tensor, t: Tensor) -> Tensor:
    """Pack quaternion (...,4) and translation (...,3) into (...,7)."""
    return torch.cat([q, t], dim=-1)


def rotation(T: Tensor) -> Tensor:
    return T[..., :4]


def translation(T: Tensor) -> Tensor:
    return T[..., 4:7]


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """a × b over the last axis, broadcasting (jnp.cross's op order)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_normalize(q: Tensor) -> Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a ⊗ b, scalar-first, broadcasting over batch dims."""
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    # negation, not a product with a [1,-1,-1,-1] constant: building that
    # constant on a GPU is a blocking host-to-device copy per call
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v (...,3) by unit quaternions q (...,4).

    Uses the two-cross-product form ``v + 2 (qw·(qv×v) + qv×(qv×v))``."""
    qw = q[..., :1]
    qv = q[..., 1:4]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: Tensor) -> Tensor:
    """Unit quaternion (...,4) → rotation matrix (...,3,3)."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R: Tensor) -> Tensor:
    """Rotation matrix (...,3,3) → unit quaternion (...,4), branch-free
    (Shepperd's method: all four candidates, the best picked by where)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None], q0,
        torch.where(cond1[..., None], q1,
                    torch.where(cond2[..., None], q2, q3)),
    )
    # canonicalize sign (w >= 0) and normalize
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def compose(a: Tensor, b: Tensor) -> Tensor:
    """T_A_C = T_A_B ∘ T_B_C."""
    q = quat_mul(rotation(a), rotation(b))
    t = quat_rotate(rotation(a), translation(b)) + translation(a)
    return make(quat_normalize(q), t)


def inverse(T: Tensor) -> Tensor:
    qi = quat_conj(rotation(T))
    return make(qi, -quat_rotate(qi, translation(T)))


def transform_points(T: Tensor, p: Tensor) -> Tensor:
    """Apply T to points p (...,3); T broadcasts against p's batch dims."""
    return quat_rotate(rotation(T), p) + translation(T)


def relative(Ta: Tensor, Tb: Tensor) -> Tensor:
    """T_A_B = Ta^{-1} ∘ Tb."""
    return compose(inverse(Ta), Tb)


def so3_exp(w: Tensor) -> Tensor:
    """Axis-angle (...,3) → unit quaternion (...,4). Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def so3_log(q: Tensor) -> Tensor:
    """Unit quaternion (...,4) → axis-angle (...,3). Taylor-safe near id."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    qw = torch.clamp(q[..., :1], -1.0, 1.0)
    qv = q[..., 1:4]
    sin_half = torch.linalg.norm(qv, dim=-1, keepdim=True)
    half = torch.atan2(sin_half, qw)
    small = sin_half < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS),
                    2.0 * half / torch.clamp(sin_half, min=_EPS))
    return k * qv


def _so3_left_jacobian_terms(theta2: Tensor):
    """Coefficients (A, B) with V = I + A [w]x + B [w]x^2 (left Jacobian)."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return A, B


def se3_exp(xi: Tensor) -> Tensor:
    """Tangent (...,6) [w, v] → transform (...,7). ``[w]x v`` is written
    as the cross product ``w × v``."""
    w, v = xi[..., :3], xi[..., 3:6]
    q = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    A, B = _so3_left_jacobian_terms(theta2)
    Wv = _cross(w, v)
    return make(q, v + A * Wv + B * _cross(w, Wv))


def se3_log(T: Tensor) -> Tensor:
    """Transform (...,7) → tangent (...,6) [w, v]."""
    w = so3_log(rotation(T))
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=_EPS)) / theta2)
    t = translation(T)
    Wt = _cross(w, t)
    v = t - 0.5 * Wt + cot_term * _cross(w, Wt)
    return torch.cat([w, v], dim=-1)


def to_matrix(T: Tensor) -> Tensor:
    """(...,7) → homogeneous (...,4,4)."""
    R = quat_to_matrix(rotation(T))
    t = translation(T)[..., :, None]
    top = torch.cat([R, t], dim=-1)
    bottom = torch.zeros(T.shape[:-1] + (1, 4), dtype=T.dtype,
                         device=T.device)
    bottom[..., 3:].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def from_matrix(M: Tensor) -> Tensor:
    return make(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


# ---------------------------------------------------------------------------
# 4-DoF (x, y, z, yaw)
# ---------------------------------------------------------------------------


def from_xyzyaw(p: Tensor) -> Tensor:
    """4-DoF pose (...,4) [x,y,z,yaw] → transform (...,7)."""
    half = 0.5 * p[..., 3]
    zero = torch.zeros_like(half)
    q = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)
    return make(q, p[..., :3])


def to_xyzyaw(T: Tensor) -> Tensor:
    """Project a transform to 4-DoF [x,y,z,yaw] (drops roll/pitch)."""
    q = rotation(T)
    yaw = torch.atan2(
        2.0 * (q[..., 0] * q[..., 3] + q[..., 1] * q[..., 2]),
        1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2))
    return torch.cat([translation(T), yaw[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Interpolation & pose histories
# ---------------------------------------------------------------------------


def interpolate(Ta: Tensor, Tb: Tensor, alpha) -> Tensor:
    """Componentwise interpolation: lerp translation, slerp rotation
    (nlerp where the quaternions are nearly parallel, sin θ < 1e-5)."""
    alpha = torch.as_tensor(alpha, dtype=Ta.dtype, device=Ta.device)[
        ..., None]
    qa, qb = rotation(Ta), rotation(Tb)
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-5
    den = torch.clamp(sin_theta, min=_EPS)
    wa = torch.where(near, 1.0 - alpha,
                     torch.sin((1.0 - alpha) * theta) / den)
    wb = torch.where(near, alpha, torch.sin(alpha * theta) / den)
    q = quat_normalize(wa * qa + wb * qb)
    t = (1.0 - alpha) * translation(Ta) + alpha * translation(Tb)
    return make(q, t)


def lookup_pose(stamps: Tensor, poses: Tensor, t) -> Tensor:
    """Interpolated pose at time t from a timestamped history: stamps
    (N,) sorted, poses (N,7); t clamped to [stamps[0], stamps[-1]]."""
    t = torch.as_tensor(t, dtype=stamps.dtype, device=stamps.device)
    idx = torch.clamp(torch.searchsorted(stamps, t, right=True), 1,
                      stamps.shape[0] - 1)
    t0, t1 = stamps[idx - 1], stamps[idx]
    alpha = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=_EPS), 0.0, 1.0)
    return interpolate(poses[idx - 1], poses[idx], alpha)


# ---------------------------------------------------------------------------
# NumPy twins for host-side control code
# ---------------------------------------------------------------------------


def _np_quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _np_quat_rotate(q, v):
    qw = q[..., :1]
    qv = q[..., 1:4]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def identity_np(dtype=None):
    """NumPy twin of identity()."""
    return np.array([1.0, 0, 0, 0, 0, 0, 0], dtype or np.float32)


def compose_np(a, b):
    """NumPy twin of compose()."""
    a = np.asarray(a)
    b = np.asarray(b)
    q = _np_quat_mul(a[..., :4], b[..., :4])
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    t = _np_quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return np.concatenate([q, t], axis=-1)


def inverse_np(T):
    """NumPy twin of inverse()."""
    T = np.asarray(T)
    qi = T[..., :4] * np.array([1.0, -1, -1, -1], T.dtype)
    return np.concatenate(
        [qi, -_np_quat_rotate(qi, T[..., 4:7])], axis=-1)


def relative_np(Ta, Tb):
    """NumPy twin of relative()."""
    return compose_np(inverse_np(Ta), Tb)


def transform_points_np(T, p):
    """NumPy twin of transform_points(): T (7,) applied to p (...,3)."""
    T = np.asarray(T)
    p = np.asarray(p)
    return _np_quat_rotate(T[None, :4], p) + T[None, 4:7]


def lookup_pose_np(stamps, poses, t: float):
    """NumPy twin of lookup_pose() for host-side bookkeeping (one time
    ``t``) → (7,) float32."""
    stamps = np.asarray(stamps)
    poses = np.asarray(poses)
    idx = int(np.clip(np.searchsorted(stamps, t, side="right"), 1,
                      len(stamps) - 1))
    t0, t1 = stamps[idx - 1], stamps[idx]
    a = float(np.clip((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0))
    qa, qb = poses[idx - 1, :4], poses[idx, :4]
    if np.dot(qa, qb) < 0:
        qb = -qb
    dot = np.clip(abs(np.dot(qa, qb)), -1.0, 1.0)
    theta = np.arccos(dot)
    if np.sin(theta) < 1e-5:
        q = (1 - a) * qa + a * qb
    else:
        q = (np.sin((1 - a) * theta) * qa + np.sin(a * theta) * qb) \
            / np.sin(theta)
    q = q / max(np.linalg.norm(q), 1e-9)
    tr = (1 - a) * poses[idx - 1, 4:] + a * poses[idx, 4:]
    return np.concatenate([q, tr]).astype(np.float32)
