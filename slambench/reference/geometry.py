"""Plain SE(3) arithmetic of the benchmark's yardstick, in any float dtype.

Poses are (..., 7) tensors [qw, qx, qy, qz, tx, ty, tz] (scalar-first unit
quaternion, then translation), the layout the system under test takes as
input. Tangents are (..., 6) [w, v]: rotation first. Nothing here imports
the system under test.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor
EPS = 1e-8


def cross(a: Tensor, b: Tensor) -> Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=EPS)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """v + 2·(qw·(qv × v) + qv × (qv × v))."""
    qv = q[..., 1:4]
    uv = cross(qv, v)
    return v + 2.0 * (q[..., :1] * uv + cross(qv, uv))


def quat_to_matrix(q: Tensor) -> Tensor:
    w, x, y, z = (q[..., i] for i in range(4))
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R: Tensor) -> Tensor:
    """Rotation matrices (..., 3, 3) → unit quaternions with w ≥ 0."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = []
    s = torch.sqrt(torch.clamp(1.0 + tr, min=EPS)) * 2.0
    cands.append(torch.stack([0.25 * s, (m[..., 2, 1] - m[..., 1, 2]) / s,
                              (m[..., 0, 2] - m[..., 2, 0]) / s,
                              (m[..., 1, 0] - m[..., 0, 1]) / s], -1))
    for a in range(3):
        b, c = (a + 1) % 3, (a + 2) % 3
        s = torch.sqrt(torch.clamp(1.0 + m[..., a, a] - m[..., b, b]
                                   - m[..., c, c], min=EPS)) * 2.0
        q = [None] * 4
        q[0] = (m[..., c, b] - m[..., b, c]) / s
        q[1 + a] = 0.25 * s
        q[1 + b] = (m[..., a, b] + m[..., b, a]) / s
        q[1 + c] = (m[..., a, c] + m[..., c, a]) / s
        cands.append(torch.stack(q, -1))
    diag = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    pick = torch.where(tr > 0, 0, 1 + diag.argmax(dim=-1))
    q = torch.stack(cands, -2).gather(
        -2, pick[..., None, None].expand(pick.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def make(q: Tensor, t: Tensor) -> Tensor:
    return torch.cat([q, t], dim=-1)


def compose(a: Tensor, b: Tensor) -> Tensor:
    q = quat_normalize(quat_mul(a[..., :4], b[..., :4]))
    return make(q, quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7])


def inverse(T: Tensor) -> Tensor:
    qi = quat_conj(T[..., :4])
    return make(qi, -quat_rotate(qi, T[..., 4:7]))


def relative(Ta: Tensor, Tb: Tensor) -> Tensor:
    """Ta⁻¹ ∘ Tb."""
    return compose(inverse(Ta), Tb)


def transform_points(T: Tensor, p: Tensor) -> Tensor:
    return quat_rotate(T[..., :4], p) + T[..., 4:7]


def _safe(small: Tensor, x: Tensor) -> Tensor:
    """x where it is used, 1 where a series replaces it: the division
    under the unused branch stays finite, and so do its gradients."""
    return torch.where(small, torch.ones_like(x), x)


def so3_exp(w: Tensor) -> Tensor:
    th2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = th2 < 1e-8
    th = torch.sqrt(_safe(small, th2))
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    qw = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def so3_log(q: Tensor) -> Tensor:
    q = torch.where(q[..., :1] < 0, -q, q)
    qw = torch.clamp(q[..., :1], -1.0, 1.0)
    qv = q[..., 1:4]
    sh2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = sh2 < 1e-12
    sh = torch.sqrt(_safe(small, sh2))
    k = torch.where(small, 2.0 / torch.clamp(qw, min=EPS),
                    2.0 * torch.atan2(sh, qw) / sh)
    return k * qv


def se3_exp(xi: Tensor) -> Tensor:
    """[w, v] → pose; translation V(w)·v."""
    w, v = xi[..., :3], xi[..., 3:6]
    th2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = th2 < 1e-8
    t2 = _safe(small, th2)
    th = torch.sqrt(t2)
    A = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / t2)
    B = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (t2 * th))
    wv = cross(w, v)
    return make(so3_exp(w), v + A * wv + B * cross(w, wv))


def se3_log(T: Tensor) -> Tensor:
    w = so3_log(T[..., :4])
    th2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = th2 < 1e-8
    t2 = _safe(small, th2)
    half = 0.5 * torch.sqrt(t2)
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - half * torch.cos(half) / torch.sin(half)) / t2)
    t = T[..., 4:7]
    wt = cross(w, t)
    return torch.cat([w, t - 0.5 * wt + c * cross(w, wt)], dim=-1)


# --- float64 numpy on the host (traffic generation) -----------------------

def np_to_matrix(T: np.ndarray) -> np.ndarray:
    """(..., 7) → (..., 4, 4) float64."""
    T = np.asarray(T, np.float64)
    R = quat_to_matrix(torch.from_numpy(T[..., :4])).numpy()
    M = np.zeros(T.shape[:-1] + (4, 4))
    M[..., :3, :3] = R
    M[..., :3, 3] = T[..., 4:7]
    M[..., 3, 3] = 1.0
    return M


def np_from_matrix(M: np.ndarray) -> np.ndarray:
    """(..., 4, 4) → (..., 7) float64."""
    q = matrix_to_quat(torch.from_numpy(np.asarray(M[..., :3, :3],
                                                   np.float64))).numpy()
    return np.concatenate([q, M[..., :3, 3]], axis=-1)


def np_exp_matrix(xi: np.ndarray) -> np.ndarray:
    """Tangents (..., 6) → (..., 4, 4) float64."""
    return np_to_matrix(se3_exp(torch.from_numpy(
        np.asarray(xi, np.float64))).numpy())
