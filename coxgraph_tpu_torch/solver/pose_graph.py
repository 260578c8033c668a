"""Batched Levenberg-Marquardt pose-graph optimizer — port of
``coxgraph_tpu.solver.pose_graph``.

Constraints live in fixed-capacity pools with validity masks.
``start_submap`` chains one relative-pose constraint per new submap and,
when configured, one height prior. ``add`` past capacity drops the row
but still advances ``count`` — an unclamped insertion watermark, so
``num_dropped`` makes saturation observable. ``add`` is functional
(returns a new pool); the pools are small.

The solve evaluates the residuals and their Jacobians for ALL constraints
at once, assembles a dense (6N, 6N) system by scatter-add and solves the
damped system by Cholesky. The Jacobians at δ = 0 are written out: with
E = T_meas⁻¹·T_i⁻¹·T_j and ξ = log E, ∂r/∂δ_j = S·J_r⁻¹(ξ) and ∂r/∂δ_i
= −S·J_r⁻¹(ξ)·Ad(T_j⁻¹·T_i), J_r⁻¹ from the closed-form SO(3) block and
the exponential series of the coupling block (what the reference's
``jax.jacfwd`` computes through its geometry, to f32 rounding). Accept/reject and
the damping update stay on the device: an LM iteration issues no
device-to-host read. A failed factorization yields NaN, so the step is
rejected, as with ``jax.scipy.linalg.solve(..., assume_a="pos")``.

Gauge freedom is removed by holding fixed poses (default: pose 0) via
row/column masking with a unit diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core import geometry as geo
from ..utils.tensorops import put_row

Tensor = torch.Tensor


def _cloned(obj):
    return type(obj)(**{f.name: getattr(obj, f.name).clone()
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class RelPoseConstraints:
    """Fixed-capacity pool of relative-pose constraints
    r = sqrt_info · log(T_meas⁻¹ · T_i⁻¹ · T_j)."""

    i: Tensor          # (M,) int32
    j: Tensor          # (M,) int32
    T_meas: Tensor     # (M,7)
    sqrt_info: Tensor  # (M,6,6)
    valid: Tensor      # (M,) bool
    count: Tensor      # () int32 — insertion watermark

    @staticmethod
    def empty(capacity: int, device) -> "RelPoseConstraints":
        return RelPoseConstraints(
            i=torch.zeros((capacity,), dtype=torch.int32, device=device),
            j=torch.zeros((capacity,), dtype=torch.int32, device=device),
            T_meas=geo.identity(device)[None].repeat(capacity, 1),
            sqrt_info=torch.eye(6, device=device)[None].repeat(
                capacity, 1, 1),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def add(self, i, j, T_meas: Tensor, sqrt_info=None
            ) -> "RelPoseConstraints":
        """Append one constraint (``i``/``j`` ints or 0-d device tensors).
        Past capacity the row is dropped but ``count`` keeps advancing."""
        out = _cloned(self)
        k = self.count
        si = (torch.eye(6, device=T_meas.device) if sqrt_info is None
              else sqrt_info)
        put_row(out.i, k, i)
        put_row(out.j, k, j)
        put_row(out.T_meas, k, T_meas)
        put_row(out.sqrt_info, k, si)
        put_row(out.valid, k, True)
        out.count = k + 1
        return out

    @property
    def capacity(self) -> int:
        return self.i.shape[0]

    def num_dropped(self) -> int:
        """Constraints lost to pool overflow (one host readback)."""
        return max(0, int(self.count) - self.capacity)


@dataclasses.dataclass
class HeightConstraints:
    """Fixed-capacity pool of absolute height priors
    r = (1/stddev) · (position_z(T_i) - height)."""

    i: Tensor           # (M,) int32
    height: Tensor      # (M,)
    info: Tensor        # (M,)  1/stddev whitening weight
    valid: Tensor       # (M,) bool
    count: Tensor       # () int32

    @staticmethod
    def empty(capacity: int, device) -> "HeightConstraints":
        return HeightConstraints(
            i=torch.zeros((capacity,), dtype=torch.int32, device=device),
            height=torch.zeros((capacity,), device=device),
            info=torch.ones((capacity,), device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def add(self, i, height, stddev: float = 1.0) -> "HeightConstraints":
        """Append one height prior (unclamped ``count`` watermark past
        capacity — see RelPoseConstraints.add)."""
        out = _cloned(self)
        k = self.count
        put_row(out.i, k, i)
        put_row(out.height, k, height)
        put_row(out.info, k, 1.0 / stddev)
        put_row(out.valid, k, True)
        out.count = k + 1
        return out

    @property
    def capacity(self) -> int:
        return self.i.shape[0]

    def num_dropped(self) -> int:
        """Priors lost to pool overflow (one host readback)."""
        return max(0, int(self.count) - self.capacity)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """LM solve parameters (the JAX package's fields and defaults): a
    fixed iteration count, fully on the device."""

    iterations: int = 15
    damping_init: float = 1e-4
    damping_up: float = 10.0
    damping_down: float = 0.3
    huber_delta: float = 0.0    # 0 = disabled
    yaw_only: bool = False      # 4-DoF mode (AngleLocalParameterization)


def _constraint_residual(Ti: Tensor, Tj: Tensor, T_meas: Tensor,
                         sqrt_info: Tensor) -> Tensor:
    """Whitened 6-residuals (M,6) of relative-pose constraints (M rows)."""
    err = geo.compose(geo.inverse(T_meas),
                      geo.compose(geo.inverse(Ti), Tj))
    return (sqrt_info @ geo.se3_log(err)[..., None])[..., 0]


def _gather(x: Tensor, idx: Tensor) -> Tensor:
    return x.index_select(0, idx.long())


def residuals(poses: Tensor, c: RelPoseConstraints) -> Tensor:
    """All whitened residuals (M,6); invalid rows are zero."""
    r = _constraint_residual(_gather(poses, c.i), _gather(poses, c.j),
                             c.T_meas, c.sqrt_info)
    return torch.where(c.valid[:, None], r, 0.0)


def _height_residual(Ti: Tensor, height: Tensor, info: Tensor) -> Tensor:
    """Whitened scalar height residual info·(z(T_i) − height)."""
    return info * (geo.translation(Ti)[..., 2] - height)


def height_residuals(poses: Tensor, h: HeightConstraints) -> Tensor:
    """All whitened height residuals (M,); invalid rows are zero."""
    r = _height_residual(_gather(poses, h.i), h.height, h.info)
    return torch.where(h.valid, r, 0.0)


def _hat(v: Tensor) -> Tensor:
    """(...,3) → the cross-product matrices (...,3,3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _blocks(a: Tensor, b: Tensor, c: Tensor, d: Tensor) -> Tensor:
    """[[a, b], [c, d]] of (...,3,3) blocks → (...,6,6)."""
    return torch.cat([torch.cat([a, b], dim=-1),
                      torch.cat([c, d], dim=-1)], dim=-2)


# terms of the exponential series of the SE(3) right Jacobian: the last
# one is below 2e-10 of the first at |ξ_rot| = π, and a logarithm's
# rotation angle is at most π
_SERIES_TERMS = 20


def se3_right_jacobian_inv(xi: Tensor) -> Tensor:
    """J_r⁻¹(ξ) (...,6,6) of tangents ξ = [w, v] (...,6): the derivative
    of log(exp(ξ)·exp(δ)) in δ at 0. Block lower triangular [[A, 0],
    [−A·Q·A, A]]: A = J_r⁻¹(w) of SO(3) in closed form (se3_log's
    coefficient), Q the coupling block of J_r(ξ) = Σ (−ad ξ)ᵏ/(k+1)!."""
    w, v = xi[..., :3], xi[..., 3:6]
    W, V = _hat(w), _hat(v)
    zero = torch.zeros_like(W)
    X = _blocks(-W, zero, -V, -W)               # −ad ξ
    term = torch.eye(6, dtype=xi.dtype, device=xi.device).expand_as(X)
    acc = term
    for k in range(1, _SERIES_TERMS + 1):
        term = (term @ X) * (1.0 / (k + 1))
        acc = acc + term
    Q = acc[..., 3:, :3]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=geo._EPS * geo._EPS))
    half = 0.5 * theta
    cot_term = torch.where(
        theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=geo._EPS)) / theta2)
    A = torch.eye(3, dtype=xi.dtype, device=xi.device) + 0.5 * W \
        + cot_term * (W @ W)
    return _blocks(A, zero, -(A @ Q @ A), A)


def adjoint(T: Tensor) -> Tensor:
    """Ad(T) (...,6,6) on [w, v] tangents: T·exp(δ)·T⁻¹ = exp(Ad(T)·δ)."""
    R = geo.quat_to_matrix(geo.rotation(T))
    return _blocks(R, torch.zeros_like(R), _hat(geo.translation(T)) @ R, R)


def renormalized(T: Tensor) -> Tensor:
    """T ∘ exp(0): the pose with its quaternion renormalized, where the
    reference evaluates its residuals and Jacobians (at δ = 0)."""
    return geo.make(geo.quat_normalize(geo.rotation(T)), geo.translation(T))


def _residuals_and_jacobians(Ti: Tensor, Tj: Tensor, T_meas: Tensor,
                             sqrt_info: Tensor):
    """→ (r (M,6), ∂r/∂δ_i (M,6,6), ∂r/∂δ_j (M,6,6)) of relative-pose
    constraints at δ = 0 (right-multiplicative tangents)."""
    Ti, Tj = renormalized(Ti), renormalized(Tj)
    err = geo.compose(geo.inverse(T_meas), geo.compose(geo.inverse(Ti), Tj))
    xi = geo.se3_log(err)
    r = (sqrt_info @ xi[..., None])[..., 0]
    Jj = sqrt_info @ se3_right_jacobian_inv(xi)
    Ji = -(Jj @ adjoint(geo.relative(Tj, Ti)))
    return r, Ji, Jj


def _yaw_keep(x: Tensor) -> Tensor:
    """The 4-DoF mask [0, 0, 1, 1, 1, 1] on the last axis of ``x`` (built
    on the device: a constant tensor would be a host-to-device copy)."""
    keep = torch.ones(6, dtype=x.dtype, device=x.device)
    keep[:2].fill_(0.0)
    return keep


def scatter_blocks(n: int, rows: Tensor, cols: Tensor,
                   blocks: Tensor) -> Tensor:
    """Sum (K,6,6) blocks into a dense (6n,6n) matrix at block positions
    (rows[k], cols[k]), repeats accumulating."""
    H = blocks.new_zeros((n * n, 6, 6))
    H.index_add_(0, (rows.long() * n + cols.long()), blocks)
    return H.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def scatter_rows(n: int, rows: Tensor, vecs: Tensor) -> Tensor:
    """Sum (K,6) vectors into a (6n,) vector at block rows[k]."""
    b = vecs.new_zeros((n, 6))
    b.index_add_(0, rows.long(), vecs)
    return b.reshape(6 * n)


def gauge_fix(H: Tensor, b: Tensor, fmask: Tensor):
    """Zero the rows and columns of the frozen coordinates ``fmask``
    (6n,), put ones on their diagonal and zero their b."""
    H = torch.where(fmask[:, None] | fmask[None, :], 0.0, H)
    H = H + torch.diag(fmask.to(H.dtype))
    return H, torch.where(fmask, 0.0, b)


def _build_normal_equations(poses: Tensor, c: RelPoseConstraints,
                            cfg: SolverConfig, fixed: Tensor,
                            h: Optional[HeightConstraints] = None):
    """→ (H (6N,6N), b (6N,), cost ()): Gauss-Newton normal equations of
    the (Huber-weighted) relative-pose and height residuals at
    ``poses``, gauge-fixed."""
    n = poses.shape[0]
    Ti, Tj = _gather(poses, c.i), _gather(poses, c.j)

    r, Ji, Jj = _residuals_and_jacobians(Ti, Tj, c.T_meas, c.sqrt_info)

    # robust (Huber) weighting on the whitened residual norm
    if cfg.huber_delta > 0:
        nrm = torch.linalg.norm(r, dim=-1)
        w = torch.sqrt(torch.clamp(
            cfg.huber_delta / torch.clamp(nrm, min=1e-12), max=1.0))
        r = r * w[:, None]
        Ji = Ji * w[:, None, None]
        Jj = Jj * w[:, None, None]

    m = c.valid[:, None]
    r = torch.where(m, r, 0.0)
    Ji = torch.where(m[..., None], Ji, 0.0)
    Jj = torch.where(m[..., None], Jj, 0.0)

    if cfg.yaw_only:
        # 4-DoF: only (yaw, x, y, z) vary — zero the roll/pitch columns
        keep = _yaw_keep(Ji)
        Ji = Ji * keep
        Jj = Jj * keep

    Hii = torch.einsum("mab,mac->mbc", Ji, Ji)
    Hjj = torch.einsum("mab,mac->mbc", Jj, Jj)
    Hij = torch.einsum("mab,mac->mbc", Ji, Jj)
    rows = [c.i, c.j, c.i, c.j]
    cols = [c.i, c.j, c.j, c.i]
    blocks = [Hii, Hjj, Hij, Hij.transpose(-1, -2)]
    b_rows = [c.i, c.j]
    b_vecs = [torch.einsum("mab,ma->mb", Ji, r),
              torch.einsum("mab,ma->mb", Jj, r)]
    cost = 0.5 * torch.sum(r * r)

    if h is not None and h.i.shape[0] > 0:
        Th = _gather(poses, h.i)
        rh = torch.where(h.valid,
                         _height_residual(Th, h.height, h.info), 0.0)
        # z(T·exp(δ)) moves with δ's translation through T's third row
        R2 = geo.quat_to_matrix(geo.rotation(renormalized(Th)))[:, 2, :]
        Jh = torch.cat([torch.zeros_like(R2), h.info[:, None] * R2], dim=-1)
        Jh = torch.where(h.valid[:, None], Jh, 0.0)
        if cfg.yaw_only:
            Jh = Jh * _yaw_keep(Jh)
        rows.append(h.i)
        cols.append(h.i)
        blocks.append(torch.einsum("ma,mb->mab", Jh, Jh))
        b_rows.append(h.i)
        b_vecs.append(Jh * rh[:, None])
        cost = cost + 0.5 * torch.sum(rh * rh)

    H = scatter_blocks(n, torch.cat(rows), torch.cat(cols),
                       torch.cat(blocks))
    b = scatter_rows(n, torch.cat(b_rows), torch.cat(b_vecs))

    # gauge fixing: fixed poses (and, in 4-DoF mode, the roll/pitch
    # coordinates of every pose) are frozen
    fmask = torch.repeat_interleave(fixed, 6)
    if cfg.yaw_only:
        coord = torch.arange(6 * n, device=poses.device) % 6
        fmask = fmask | (coord < 2)
    H, b = gauge_fix(H, b, fmask)
    return H, b, cost


def _apply_delta(poses: Tensor, delta: Tensor, cfg: SolverConfig) -> Tensor:
    d = delta.reshape(-1, 6)
    if cfg.yaw_only:
        d = d * _yaw_keep(d)
    return geo.compose(poses, geo.se3_exp(d))


def _total_cost(poses: Tensor, c: RelPoseConstraints, cfg: SolverConfig,
                h: Optional[HeightConstraints] = None) -> Tensor:
    r = residuals(poses, c)
    if cfg.huber_delta > 0:
        nrm = torch.linalg.norm(r, dim=-1)
        w = torch.clamp(cfg.huber_delta / torch.clamp(nrm, min=1e-12),
                        max=1.0)
        cost = 0.5 * torch.sum(w * nrm * nrm)
    else:
        cost = 0.5 * torch.sum(r * r)
    if h is not None and h.i.shape[0] > 0:
        rh = height_residuals(poses, h)
        cost = cost + 0.5 * torch.sum(rh * rh)
    return cost


def cho_solve(A: Tensor, b: Tensor) -> Tensor:
    """x solving A x = b for a symmetric positive definite A (n,n) by
    Cholesky; NaN where the factorization fails. No host-side info
    check (``torch.linalg.solve``/``cholesky`` would sync on it)."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    return torch.where(info == 0, x, float("nan"))


def damped_solve(H: Tensor, b: Tensor, lam: Tensor) -> Tensor:
    """δ solving (H + λ·diag(max(diag H, 1e-8))) δ = −b."""
    return cho_solve(
        H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8)), -b)


def lm_update(accept: Tensor, lam: Tensor, cfg: SolverConfig) -> Tensor:
    """The damping after an accepted (down) or rejected (up) step,
    clipped to [1e-9, 1e6]."""
    lam = torch.where(accept, lam * cfg.damping_down, lam * cfg.damping_up)
    return torch.clamp(lam, 1e-9, 1e6)


class SolveResult(NamedTuple):
    poses: Tensor
    cost: Tensor          # final cost
    initial_cost: Tensor
    iterations: Tensor


def touched_poses(n: int, constraints: RelPoseConstraints,
                  heights: Optional[HeightConstraints] = None) -> Tensor:
    """(n,) bool: the poses some valid constraint or height prior
    references."""
    dev = constraints.i.device
    idx = [torch.where(constraints.valid, constraints.i, n),
           torch.where(constraints.valid, constraints.j, n)]
    if heights is not None and heights.i.shape[0] > 0:
        idx.append(torch.where(heights.valid, heights.i, n))
    idx = torch.cat(idx).long()
    touched = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    touched.scatter_(0, idx, torch.ones_like(idx, dtype=torch.bool))
    return touched[:n]


def default_fixed(n: int, device) -> Tensor:
    """(n,) bool holding pose 0 only."""
    return torch.arange(n, device=device) == 0


def optimize(poses: Tensor, constraints: RelPoseConstraints,
             cfg: SolverConfig = SolverConfig(),
             fixed: Optional[Tensor] = None,
             heights: Optional[HeightConstraints] = None) -> SolveResult:
    """LM optimization of poses (N,7) under relative-pose constraints
    (plus optional absolute height priors). ``fixed`` (N,) bool holds
    poses constant (default: pose 0 only). Poses no valid constraint or
    height prior references are held constant too (they would make H
    singular); a pose referenced only by a height prior still moves.

    Runs ``cfg.iterations`` iterations with no device-to-host read."""
    n = poses.shape[0]
    if fixed is None:
        fixed = default_fixed(n, poses.device)
    fixed = fixed | ~touched_poses(n, constraints, heights)

    init_cost = _total_cost(poses, constraints, cfg, heights)
    lam = torch.full((), cfg.damping_init, dtype=poses.dtype,
                     device=poses.device)
    for _ in range(cfg.iterations):
        H, b, cost = _build_normal_equations(poses, constraints, cfg, fixed,
                                             heights)
        delta = damped_solve(H, b, lam)
        new_poses = _apply_delta(poses, delta, cfg)
        new_cost = _total_cost(new_poses, constraints, cfg, heights)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        lam = lm_update(accept, lam, cfg)
    return SolveResult(
        poses=poses,
        cost=_total_cost(poses, constraints, cfg, heights),
        initial_cost=init_cost,
        iterations=torch.full((), cfg.iterations, dtype=torch.int32,
                              device=poses.device))
