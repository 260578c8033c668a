"""Dense submap-to-submap registration — port of
``coxgraph_tpu.ops.registration``.

Residual per sampled surface point p of submap A:
    r(p) = sdf_B( T_B⁻¹ · T_O_A · p ) − sdf_A(p)
i.e. A's explicit surface evaluated in B's implicit field. The points are
a fixed-capacity cache of high-weight surface-band voxel centres,
extracted once per submap.

The 12-dim pose Jacobian of each residual (right-multiplicative tangents
δ_A, δ_B, [w, v] each) is written out: the trilinear sample is piecewise
linear in the point, so its gradient is Σ_c sdf_c · ∂w_c/∂frac · (1/s)
(the base voxel's floor has derivative zero), chained with the point's
derivatives J_A = [p × h, h], h = R_Aᵀ R_B ∇, and J_B = [∇ × p_B, −∇].
This is what ``jax.jacfwd`` computes through the reference's sampler.
Every pair and every point is one batched pass; nothing reads back to
the host. ``pair_terms`` here is the plain version: on the card the terms
come from one kernel, ``cuda_registration.pair_terms``, which every caller
goes through.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core import geometry as geo
from ..core import voxel as vx
from ..solver.pose_graph import cho_solve, renormalized
from ..utils.tensorops import f32_reciprocal
from . import cuda_registration    # imports this module back

Tensor = torch.Tensor

# flat index hash of the top-k tie jitter (a uint32 multiply that wraps)
_HASH = 2654435761


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """The JAX package's fields and defaults."""

    max_points: int = 2048        # surface samples per submap
    min_weight: float = 0.1       # observation gate
    band: float = 0.5             # |sdf| < band·truncation counts as surface
    huber_delta: float = 0.1      # m, robust loss on sdf residuals
    iterations: int = 12          # GN iterations for pairwise alignment
    damping: float = 1e-3
    # LM iterations per chunk of the phase-2 solve
    # (global_opt.optimize_two_phase); 0 ⇒ all iterations in one chunk.
    # Chunking changes no result.
    phase2_dispatch_iters: int = 0
    # block budget per submap in the stacked field of the phase-2 solve:
    # pool rows [0, R) of every submap; later blocks fall out of the
    # registration sampling only
    max_reg_blocks: int = 1024


def _score(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
           cfg: RegistrationConfig) -> Tensor:
    """Flat (max_blocks·v³,) selection score: the weight of surface-band
    voxels of live blocks with a deterministic tie jitter below 1e-3
    relative, −1 elsewhere."""
    live = (torch.arange(layer.max_blocks, device=layer.sdf.device)
            < layer.num_blocks)[:, None]
    surf = (live & (layer.weight > cfg.min_weight)
            & (torch.abs(layer.sdf) < cfg.band * spec.truncation))
    score = torch.where(surf, layer.weight, -1.0).reshape(-1)
    # saturated weights would otherwise tie and collapse the selection
    # into the earliest-allocated blocks; the hash is the reference's
    # uint32 multiply, computed in int64 and wrapped to 32 bits
    h = (torch.arange(score.shape[0], dtype=torch.int64,
                      device=score.device) * _HASH) & 0xFFFFFFFF
    jitter = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.where(score > 0, score * (1.0 + 1e-3 * jitter), score)


def extract_surface_points(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                           cfg: RegistrationConfig) -> Tuple[Tensor, Tensor]:
    """→ (points (P,3) in the layer frame, mask (P,)): the P =
    ``cfg.max_points`` highest-scoring voxel centres, ties to the lower
    flat index (``lax.top_k``'s order, by a stable sort)."""
    score = _score(spec, layer, cfg)
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:cfg.max_points], idx[:cfg.max_points]
    v = spec.voxels_per_side
    blk = idx // (v ** 3)
    lin = idx % (v ** 3)
    local = torch.stack([lin // (v * v), (lin // v) % v, lin % v], dim=-1)
    # vx.voxel_centers_of_block's arithmetic at the selected voxels only
    pts = (vx.block_origin(spec, layer.block_coords.index_select(0, blk))
           + (local.to(torch.float32) + 0.5) * spec.voxel_size)
    return pts, top > 0.0


def surface_point_cache(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                        cfg: RegistrationConfig):
    """→ (pts (P,3), sdf (P,), mask (P,)): the per-submap registration
    point cache, extracted once per submap version and reused by every
    pair and GN iteration."""
    pts, mask = extract_surface_points(spec, layer, cfg)
    s, _, ok = vx.sample_tsdf_trilinear(spec, layer, pts)
    return pts, torch.where(ok, s, 0.0), mask & ok


# a block-coordinate (...,3) int32 → pool-row (...,) int (−1 if missing)
SlotFn = Callable[[Tensor], Tensor]


def stacked_slots(spec: vx.VoxelGridSpec, bi: Tensor,
                  pair_j: Optional[Tensor], R: int) -> SlotFn:
    """Block lookup of pair p in table row pair_j[p] of S submaps' stacked
    field (rows j·R + [0, R)): block coords (P, ..., 3) → rows of the flat
    pool (-1 if missing). ``bi`` (S, G³) holds rows in [0, R) or -1;
    ``pair_j`` None: row 0 for every point, ``vx.lookup_block``'s
    arithmetic."""
    g3 = bi.shape[1]
    flat_bi = bi.reshape(-1)

    def slot_of(b):
        slot = vx.block_grid_slot(spec, b)
        if pair_j is None:
            return torch.where(vx.block_in_grid(spec, b),
                               flat_bi[slot.long()], -1)
        j = pair_j.long().reshape((-1,) + (1,) * (b.dim() - 2))
        v = flat_bi[j * g3 + slot]
        ok = vx.block_in_grid(spec, b) & (v >= 0)
        return torch.where(ok, v + j * R, -1)

    return slot_of


def sample_with_gradient(spec: vx.VoxelGridSpec, sdf: Tensor,
                         weight: Tensor, slot_of: SlotFn, p: Tensor):
    """Trilinear sample of the pool rows ``sdf``/``weight`` (N, v³) at
    points p (...,3), blocks found by ``slot_of`` → (sdf, valid, ∂sdf/∂p
    (...,3)). The value is ``vx.sample_tsdf_trilinear``'s (same corner
    order); valid needs all 8 corners allocated and observed."""
    v0, frac = vx.trilinear_base(spec, p)
    f = [frac[..., a] for a in range(3)]
    vps = spec.voxels_per_side
    sdf_flat, w_flat = sdf.reshape(-1), weight.reshape(-1)
    acc = torch.zeros(p.shape[:-1], dtype=sdf.dtype, device=p.device)
    grad = [torch.zeros_like(acc) for _ in range(3)]
    valid = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                d = (dx, dy, dz)
                b, lv = vx.voxel_to_block(spec, vx.shift(v0, d))
                idx = slot_of(b)
                ok = idx >= 0
                lin = (lv[..., 0] * vps + lv[..., 1]) * vps + lv[..., 2]
                flat = torch.where(ok, idx.long() * vps ** 3 + lin, 0)
                s = torch.where(ok, sdf_flat[flat], spec.truncation)
                w = torch.where(ok, w_flat[flat], 0.0)
                a = [f[k] if d[k] else 1 - f[k] for k in range(3)]
                acc = acc + a[0] * a[1] * a[2] * s
                for k in range(3):
                    o = [a[m] for m in range(3) if m != k]
                    term = o[0] * o[1] * s
                    grad[k] = grad[k] + term if d[k] else grad[k] - term
                valid = valid & ok & (w > 0)
    inv_s = f32_reciprocal(spec.voxel_size)
    return acc, valid, torch.stack(grad, dim=-1) * inv_s


def pair_terms(spec: vx.VoxelGridSpec, sdf: Tensor, weight: Tensor,
               slot_of: SlotFn, pts_A: Tensor, sdf_A: Tensor,
               mask_A: Tensor, T_O_A: Tensor, T_O_B: Tensor,
               huber_delta: float):
    """Huber-weighted GN terms of registration pairs, batched over any
    leading axes: pts_A (..., Q, 3), sdf_A / mask_A (..., Q), poses
    (..., 7) → (H (..., 12, 12), b (..., 12), cost (...), n_valid (...)
    int32); the 12 dims are the right tangents (δ_A, δ_B)."""
    TA = renormalized(T_O_A)[..., None, :]
    TB = renormalized(T_O_B)[..., None, :]
    p_B = geo.transform_points(geo.inverse(TB),
                               geo.transform_points(TA, pts_A))
    s, ok, g = sample_with_gradient(spec, sdf, weight, slot_of, p_B)
    ok = ok & mask_A
    r = torch.where(ok, s - sdf_A, 0.0)
    h = geo.quat_rotate(geo.quat_conj(geo.rotation(TA)),
                        geo.quat_rotate(geo.rotation(TB), g))
    J = torch.cat([geo._cross(pts_A, h), h, geo._cross(g, p_B), -g], dim=-1)
    J = torch.where(ok[..., None], J, 0.0)
    w = torch.clamp(huber_delta / torch.clamp(torch.abs(r), min=1e-9),
                    max=1.0)
    w = torch.where(ok, w, 0.0)
    wJ = w[..., None] * J
    H = torch.einsum("...qa,...qb->...ab", wJ, J)
    b = torch.einsum("...q,...qa->...a", r, wJ)
    cost = 0.5 * torch.sum(w * r * r, dim=-1)
    return H, b, cost, ok.sum(dim=-1, dtype=torch.int32)


def registration_residuals(spec: vx.VoxelGridSpec, layerB: vx.TsdfLayer,
                           pts_A: Tensor, sdf_A: Tensor, mask_A: Tensor,
                           T_O_A: Tensor, T_O_B: Tensor):
    """Residuals (P,) and validity for all sampled points at the poses."""
    p_B = geo.transform_points(
        geo.inverse(T_O_B), geo.transform_points(T_O_A, pts_A))
    s, _, ok = vx.sample_tsdf_trilinear(spec, layerB, p_B)
    ok = ok & mask_A
    return torch.where(ok, s - sdf_A, 0.0), ok


def registration_normal_eq(spec: vx.VoxelGridSpec, layerB: vx.TsdfLayer,
                           pts_A: Tensor, sdf_A: Tensor, mask_A: Tensor,
                           T_O_A: Tensor, T_O_B: Tensor,
                           huber_delta: float = 0.1):
    """GN contribution of one registration pair → (H (12,12), b (12,),
    cost, n_valid): ``cuda_registration.pair_terms`` with B's block index
    as the one table row and its whole pool as the rows."""
    return cuda_registration.pair_terms(
        spec, layerB.sdf, layerB.weight, layerB.block_index.reshape(1, -1),
        None, pts_A, sdf_A, mask_A, T_O_A, T_O_B, huber_delta)


class RegisterResult(NamedTuple):
    T_A_B: Tensor          # aligned relative pose
    cost: Tensor
    initial_cost: Tensor
    n_inliers: Tensor


def register_pair(spec: vx.VoxelGridSpec, layerA: vx.TsdfLayer,
                  layerB: vx.TsdfLayer, T_A_B_init: Tensor,
                  cfg: RegistrationConfig = RegistrationConfig(),
                  ) -> RegisterResult:
    """ICP-style alignment of submap B to submap A: refine T_A_B so that
    A's surface points fall on B's zero level set, by ``cfg.iterations``
    damped Gauss-Newton steps on B's tangent. A non-finite step, or one
    longer than 1, is dropped. No device-to-host read."""
    pts_A, mA = extract_surface_points(spec, layerA, cfg)
    sA, _, okA = vx.sample_tsdf_trilinear(spec, layerA, pts_A)
    sdf_A = torch.where(okA, sA, 0.0)
    mask_A = mA & okA
    ident = geo.identity(pts_A.device)
    damp = cfg.damping * torch.eye(6, device=pts_A.device)

    def normal_eq(T):
        # A's frame is the odometry frame: T_O_A = I, T_O_B = T
        return registration_normal_eq(spec, layerB, pts_A, sdf_A, mask_A,
                                      ident, T, cfg.huber_delta)

    T = T_A_B_init
    for _ in range(cfg.iterations):
        H, b, _, _ = normal_eq(T)
        # only δ_B varies (the relative pose); take the B block
        delta = cho_solve(H[6:, 6:] + damp, -b[6:])
        bad = ~torch.all(torch.isfinite(delta)) | (
            torch.linalg.norm(delta) > 1.0)
        delta = torch.where(bad, 0.0, delta)
        T = geo.compose(T, geo.se3_exp(delta))

    _, _, cost0, _ = normal_eq(T_A_B_init)
    _, _, cost1, n1 = normal_eq(T)
    return RegisterResult(T_A_B=T, cost=cost1, initial_cost=cost0,
                          n_inliers=n1)
