"""Feature detection, binary descriptors, matching and geometric
verification — port of ``coxgraph_tpu.ops.features``.

* Harris corners (Sobel + structure tensor), 3×3 max-pool NMS, top-K;
* upright BRIEF-256 descriptors packed into 8 words, carried as int32 bit
  patterns of the JAX package's uint32 words;
* brute-force Hamming matching with mutual nearest + ratio test, on the
  card through the CUDA kernel of ``ops.cuda_hamming``;
* batched 3-D/3-D RANSAC: every Kabsch hypothesis solved at once by a
  batched SVD, inliers counted densely, refits on the inlier set.

Parity notes. The Sobel and box filters are explicit shifted f32 sums with
zero padding, not ``conv2d``: cuDNN would round them to TF32 on the card.
``jax.lax.top_k`` puts the lowest index first among ties, so selection is a
stable descending sort. ``jax.random.choice`` has no bit-equal torch twin:
``ransac_rigid`` draws its indices with ``torch.multinomial`` on an
explicit generator and hands them to ``ransac_rigid_from_indices``, the
deterministic part, which the tests feed JAX's own indices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..frontends.synthetic import PinholeIntrinsics
from ..utils.tensorops import f32_reciprocal
from . import cuda_hamming

Tensor = torch.Tensor

_N_BITS = 256
_N_WORDS = _N_BITS // 32
# deterministic BRIEF sampling pattern (pairs within a 31px patch): the
# JAX package's draws, features.py:36-38
_rng = np.random.RandomState(7)
_PATTERN_A = _rng.randint(-15, 16, size=(_N_BITS, 2)).astype(np.int64)
_PATTERN_B = _rng.randint(-15, 16, size=(_N_BITS, 2)).astype(np.int64)
del _rng
# match_descriptors' mask value for a pair with an invalid side
_BIG = 10_000


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    max_keypoints: int = 512
    harris_k: float = 0.04
    nms_radius: int = 3
    min_response: float = 0.01   # fraction of the frame's peak response
    border: int = 16
    match_max_hamming: int = 64
    match_ratio: float = 0.9
    ransac_iters: int = 256
    ransac_inlier_dist: float = 0.1   # m
    # final refit over the inliers within this fraction of
    # ransac_inlier_dist; 0 disables
    ransac_refine_frac: float = 0.5
    # reject keypoints whose 3×3 depth neighbourhood is invalid or spreads
    # more than this fraction of the depth; 0 disables
    depth_edge_rel: float = 0.04
    min_inliers: int = 12


class Keypoints(NamedTuple):
    uv: Tensor        # (..., K, 2) float pixel coords (x, y)
    response: Tensor  # (..., K)
    valid: Tensor     # (..., K) bool
    desc: Tensor      # (..., K, 8) int32 bit patterns of packed BRIEF
    p_cam: Tensor     # (..., K, 3) backprojected camera-frame points
    has_depth: Tensor  # (..., K) bool


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device) -> Tuple[Tensor, Tensor]:
    """The BRIEF pattern on ``device``, copied there once per process."""
    return (torch.from_numpy(_PATTERN_A).to(device),
            torch.from_numpy(_PATTERN_B).to(device))


def _shift(x: Tensor, dy: int, dx: int) -> Tensor:
    """y[..., i, j] = x[..., i + dy, j + dx], zero outside (SAME padding)."""
    H, W = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)] = \
        x[..., max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)]
    return out


def _box_blur(x: Tensor, r: int = 1) -> Tensor:
    """Mean over a (2r+1)² window with zero padding, on (..., H, W)."""
    k = 2 * r + 1
    w = float(np.float32(1.0) / np.float32(k * k))
    acc = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            term = _shift(x, dy, dx) * w
            acc = term if acc is None else acc + term
    return acc


def _sobel(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(gx, gy) of the Sobel operator / 8 (cross-correlation, zero pad)."""
    k = ((-0.125, 0.0, 0.125), (-0.25, 0.0, 0.25), (-0.125, 0.0, 0.125))
    gx = gy = None
    for i, dy in enumerate((-1, 0, 1)):
        for j, dx in enumerate((-1, 0, 1)):
            s = _shift(x, dy, dx)
            if k[i][j] != 0.0:
                tx = s * k[i][j]
                gx = tx if gx is None else gx + tx
            if k[j][i] != 0.0:
                ty = s * k[j][i]
                gy = ty if gy is None else gy + ty
    return gx, gy


def harris_response(gray: Tensor, k: float = 0.04) -> Tensor:
    """Harris corner response of (..., H, W) gray images."""
    gx, gy = _sobel(gray)
    xx = _box_blur(gx * gx, 2)
    yy = _box_blur(gy * gy, 2)
    xy = _box_blur(gx * gy, 2)
    det = xx * yy - xy * xy
    tr = xx + yy
    return det - k * tr * tr


def _nms(resp: Tensor, radius: int) -> Tensor:
    """(B, H, W) → True where the response is its window's maximum
    (``max_pool2d`` pads with -inf, as the reference's reduce_window)."""
    k = 2 * radius + 1
    mx = torch.nn.functional.max_pool2d(resp[:, None], k, stride=1,
                                        padding=radius)[:, 0]
    return resp >= mx


def detect_and_describe_batch(intr: PinholeIntrinsics, colors: Tensor,
                              depths: Tensor,
                              cfg: FeatureConfig = FeatureConfig()
                              ) -> Keypoints:
    """Harris + BRIEF + backprojection over B RGB-D frames at once:
    colors (B, H, W, 3) (or gray (B, H, W)), depths (B, H, W) → Keypoints
    with (B, K, ...) fields. Issues no device-to-host read."""
    device = depths.device
    gray = (colors[..., 0] + colors[..., 1] + colors[..., 2]) \
        * f32_reciprocal(3.0) if colors.dim() == 4 else colors
    resp = harris_response(gray, cfg.harris_k)
    B, H, W = resp.shape
    K = cfg.max_keypoints
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    interior = ((xx >= cfg.border) & (xx < W - cfg.border)
                & (yy >= cfg.border) & (yy < H - cfg.border))
    peak = resp.reshape(B, -1).max(dim=1).values
    thresh = cfg.min_response * torch.clamp(peak, min=1e-12)
    good = _nms(resp, cfg.nms_radius) & (resp > thresh[:, None, None]) \
        & interior
    score = torch.where(good, resp, -1.0).reshape(B, -1)
    # lax.top_k order: descending, the lowest index first among ties
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :K], idx[:, :K]
    u = idx % W
    v = idx // W
    valid = top > 0

    # BRIEF on the blurred image
    smooth = _box_blur(gray, 2).reshape(B, H * W)
    pa, pb = _pattern(device)

    def sample(off):
        su = torch.clamp(u[..., None] + off[:, 0], 0, W - 1)
        sv = torch.clamp(v[..., None] + off[:, 1], 0, H - 1)
        return torch.gather(smooth, 1, (sv * W + su).reshape(B, -1)) \
            .reshape(B, K, _N_BITS)

    bits = (sample(pa) < sample(pb)).reshape(B, K, _N_WORDS, 32)
    weights = torch.ones((), dtype=torch.int64, device=device) \
        << torch.arange(32, device=device)
    words = (bits.to(torch.int64) * weights).sum(-1)       # < 2**32, exact
    # the uint32 word's bit pattern as int32 (defined wrap, not a cast)
    desc = torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)

    flat_depth = depths.reshape(B, H * W)
    d = torch.gather(flat_depth, 1, v * W + u)
    has_depth = (d > 0.05) & (d < 50.0) & valid
    if cfg.depth_edge_rel > 0:
        # the 3×3 depth neighbourhood with edge-replicated padding must be
        # valid and spread less than depth_edge_rel of the depth
        dmin = dmax = d
        dok = d > 0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                sv = torch.clamp(v + dy, 0, H - 1)
                su = torch.clamp(u + dx, 0, W - 1)
                s = torch.gather(flat_depth, 1, sv * W + su)
                dok = dok & (s > 0)
                dmin = torch.minimum(dmin, s)
                dmax = torch.maximum(dmax, s)
        spread_ok = (dmax - dmin) < cfg.depth_edge_rel * torch.clamp(
            d, min=0.05)
        has_depth = has_depth & dok & spread_ok
    uf = u.to(torch.float32)
    vf = v.to(torch.float32)
    x = (uf - intr.cx) * f32_reciprocal(intr.fx) * d
    y = (vf - intr.cy) * f32_reciprocal(intr.fy) * d
    p_cam = torch.stack([x, y, d], dim=-1)
    return Keypoints(uv=torch.stack([uf, vf], dim=-1), response=top,
                     valid=valid, desc=desc, p_cam=p_cam,
                     has_depth=has_depth)


def detect_and_describe(intr: PinholeIntrinsics, color: Tensor,
                        depth: Tensor,
                        cfg: FeatureConfig = FeatureConfig()) -> Keypoints:
    """Harris + BRIEF + backprojection in one pass over an RGB-D frame:
    color (H, W, 3) (or gray (H, W)), depth (H, W) → Keypoints (K, ...)."""
    kp = detect_and_describe_batch(intr, color[None], depth[None], cfg)
    return Keypoints(*(f[0] for f in kp))


_popcount32 = cuda_hamming.popcount32


def _unpack_pm1(d: Tensor) -> Tensor:
    """(..., 8) int32 words → (..., 256) bf16 of ±1 per bit."""
    bits = (d[..., :, None] >> torch.arange(32, device=d.device)) & 1
    pm1 = 2.0 * bits.to(torch.bfloat16) - 1.0
    return pm1.reshape(*d.shape[:-1], _N_WORDS * 32)


def hamming_matrix(da: Tensor, db: Tensor) -> Tensor:
    """(..., Ka, 8) × (..., Kb, 8) int32 → (..., Ka, Kb) int32 Hamming
    distances as one ±1 bf16 matmul: ``dot(a, b) = nbits − 2·hamming``.
    Exact: ±1 and every integer of magnitude ≤ 256 are exact in bf16."""
    nbits = _N_WORDS * 32
    dot = torch.matmul(_unpack_pm1(da), _unpack_pm1(db).transpose(-1, -2))
    return ((nbits - dot.to(torch.float32)) * 0.5).to(torch.int32)


def match_descriptors_batch(a_desc: Tensor, a_valid: Tensor, b_desc: Tensor,
                            b_valid: Tensor,
                            cfg: FeatureConfig = FeatureConfig()):
    """Mutual-nearest Hamming matching with ratio test of B query sets
    against cap database sets at once.

    a_desc (B, Ka, 8), a_valid (B, Ka); b_desc (B or 1, cap, Kb, 8),
    b_valid (B or 1, cap, Kb) → (idx_b (B, cap, Ka) int match in b or -1,
    d1 (B, cap, Ka)). On CUDA tensors one kernel launch."""
    d1, i1, d2, best_a = cuda_hamming.match_topk(
        a_desc.contiguous(), a_valid.contiguous(), b_desc.contiguous(),
        b_valid.contiguous(), _BIG, _BIG)
    i1 = i1.long()
    rows = torch.arange(a_desc.shape[1], device=a_desc.device)
    mutual = torch.gather(best_a, -1, i1) == rows
    ok = (mutual & (d1 <= cfg.match_max_hamming)
          & (d1.to(torch.float32) <= cfg.match_ratio * d2.to(torch.float32)))
    return torch.where(ok, i1, -1), d1


def match_descriptors(a: Keypoints, b: Keypoints,
                      cfg: FeatureConfig = FeatureConfig()):
    """Mutual-nearest Hamming matching with ratio test of one keypoint set
    against another → (idx_b (Ka,) match in b or -1, dist (Ka,))."""
    mb, d1 = match_descriptors_batch(a.desc[None], a.valid[None],
                                     b.desc[None, None], b.valid[None, None],
                                     cfg)
    return mb[0, 0], d1[0, 0]


def _det3(M: Tensor) -> Tensor:
    """Determinant of (..., 3, 3) matrices by cofactors (no LU, no sync)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _kabsch(pa: Tensor, pb: Tensor, w: Tensor) -> Tensor:
    """Weighted rigid fits T with pb ≈ R·pa + t → (..., 7) [q, t].
    pa/pb (..., N, 3), w (..., N) ≥ 0."""
    ws = torch.clamp(w.sum(-1), min=1e-6)[..., None]
    ca = (w[..., None] * pa).sum(-2) / ws
    cb = (w[..., None] * pb).sum(-2) / ws
    A = ((w[..., None] * (pb - cb[..., None, :])).transpose(-1, -2)
         @ (pa - ca[..., None, :]))
    U, _, Vt = torch.linalg.svd(A)
    d = torch.sign(_det3(U @ Vt))
    S = torch.ones(U.shape[:-1], dtype=U.dtype, device=U.device)
    S = torch.cat([S[..., :2], d[..., None]], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    t = cb - (R @ ca[..., None])[..., 0]
    return geo.make(geo.matrix_to_quat(R), t)


class RansacResult(NamedTuple):
    T_b_a: Tensor       # transform mapping a-frame points into b's frame
    n_inliers: Tensor
    inlier_mask: Tensor


def ransac_indices(valid: Tensor, iters: int,
                   generator: Optional[torch.Generator] = None) -> Tensor:
    """Hypothesis samples for ``ransac_rigid``: (..., iters, 3) indices
    drawn with replacement, ∝ validity, one row of draws per leading index.
    With no valid correspondence every index is equally likely (the
    reference then draws index 0; either way no hypothesis has an
    inlier). Issues no device-to-host read."""
    lead, M = valid.shape[:-1], valid.shape[-1]
    w = valid.reshape(-1, M).to(torch.float32)
    w = w + (w.sum(-1, keepdim=True) == 0).to(torch.float32)
    idx = torch.multinomial(w, iters * 3, replacement=True,
                            generator=generator)
    return idx.reshape(*lead, iters, 3)


def _inliers(T: Tensor, pa: Tensor, pb: Tensor, valid: Tensor,
             dist: float) -> Tensor:
    err = torch.linalg.norm(geo.transform_points(T[..., None, :], pa) - pb,
                            dim=-1)
    return valid & (err < dist)


def ransac_rigid_from_indices(pa: Tensor, pb: Tensor, valid: Tensor,
                              idx: Tensor,
                              cfg: FeatureConfig = FeatureConfig()
                              ) -> RansacResult:
    """The deterministic part of ``ransac_rigid``: score the hypotheses
    fitted to the sampled triples ``idx`` (..., iters, 3), keep the best
    (the first among equal scores), refit twice on its inliers and once
    more on the tight inliers. pa/pb (..., M, 3), valid (..., M)."""
    # int64: gather with an expanded int32 index reads wrong rows on the
    # CPU in torch 2.13
    pick = idx.long().reshape(*idx.shape[:-2], -1)          # (..., I·3)
    sa = torch.gather(pa, -2, pick[..., None].expand(*pick.shape, 3))
    sb = torch.gather(pb, -2, pick[..., None].expand(*pick.shape, 3))
    sa = sa.reshape(*idx.shape, 3)
    sb = sb.reshape(*idx.shape, 3)
    Ts = _kabsch(sa, sb, torch.ones(idx.shape, dtype=pa.dtype,
                                    device=pa.device))     # (..., I, 7)
    inl = _inliers(Ts, pa[..., None, :, :], pb[..., None, :, :],
                   valid[..., None, :], cfg.ransac_inlier_dist)
    best = torch.argmax(inl.sum(-1), dim=-1)                # first max
    T0 = torch.gather(Ts, -2, best[..., None, None].expand(
        *best.shape, 1, 7))[..., 0, :]
    inl0 = _inliers(T0, pa, pb, valid, cfg.ransac_inlier_dist)
    T1 = _kabsch(pa, pb, inl0.to(pa.dtype))
    inl1 = _inliers(T1, pa, pb, valid, cfg.ransac_inlier_dist)
    T2 = _kabsch(pa, pb, inl1.to(pa.dtype))
    if cfg.ransac_refine_frac > 0:
        tight = _inliers(T2, pa, pb, valid,
                         cfg.ransac_refine_frac * cfg.ransac_inlier_dist)
        T3 = _kabsch(pa, pb, tight.to(pa.dtype))
        T2 = torch.where((tight.sum(-1) >= 4)[..., None], T3, T2)
    return RansacResult(T_b_a=T2, n_inliers=inl1.sum(-1).to(torch.int32),
                        inlier_mask=inl1)


def ransac_rigid(pa: Tensor, pb: Tensor, valid: Tensor,
                 cfg: FeatureConfig = FeatureConfig(),
                 generator: Optional[torch.Generator] = None
                 ) -> RansacResult:
    """Batched 3-point RANSAC over 3-D/3-D correspondences (pa → pb), over
    any leading dims. ``generator`` (on pa's device) draws the samples."""
    idx = ransac_indices(valid, cfg.ransac_iters, generator)
    return ransac_rigid_from_indices(pa, pb, valid, idx, cfg)


def _inlier_spread(pa: Tensor, mask: Tensor) -> Tensor:
    """√ of the middle eigenvalue of the inlier cloud's covariance."""
    w = mask.to(torch.float32)
    n = torch.clamp(w.sum(-1), min=1.0)[..., None]
    mu = (w[..., None] * pa).sum(-2) / n
    d = (pa - mu[..., None, :]) * w[..., None]
    cov = d.transpose(-1, -2) @ d / n[..., None]
    evals = torch.linalg.eigvalsh(cov)          # ascending
    return torch.sqrt(torch.clamp(evals[..., 1], min=0.0))


def estimate_relative_pose(kp_a: Keypoints, kp_b: Keypoints,
                           cfg: FeatureConfig = FeatureConfig(),
                           generator: Optional[torch.Generator] = None,
                           return_spread: bool = False):
    """Match + RANSAC → (T_camA_camB, n_inliers[, spread]), batched over
    any leading dims of the keypoint fields (one kernel launch for the
    matching).

    T_camA_camB maps camera-B points into camera A (the MapFusion
    convention). ``return_spread`` adds the inlier cloud's planar spread
    (√ of the middle eigenvalue of its covariance, m): concentrated
    inliers make the fit rotation-degenerate, and loop detectors gate on
    it (LoopDetectorConfig.min_inlier_spread)."""
    lead = kp_a.desc.shape[:-2]
    K = kp_a.desc.shape[-2]
    a_desc = kp_a.desc.reshape(-1, K, _N_WORDS)
    b_desc = kp_b.desc.reshape(-1, 1, kp_b.desc.shape[-2], _N_WORDS)
    mb, _ = match_descriptors_batch(
        a_desc, kp_a.valid.reshape(-1, K), b_desc,
        kp_b.valid.reshape(b_desc.shape[:-1]), cfg)
    mb = mb.reshape(*lead, K)
    mbc = torch.clamp(mb, min=0)
    pa = kp_a.p_cam
    pb = torch.gather(kp_b.p_cam, -2, mbc[..., None].expand(*mbc.shape, 3))
    valid = (mb >= 0) & kp_a.has_depth & torch.gather(kp_b.has_depth, -1,
                                                      mbc)
    res = ransac_rigid(pa, pb, valid, cfg, generator)
    # ransac gives T with pB ≈ T·pA, i.e. T_camB_camA; invert
    if not return_spread:
        return geo.inverse(res.T_b_a), res.n_inliers
    return (geo.inverse(res.T_b_a), res.n_inliers,
            _inlier_spread(pa, res.inlier_mask))
