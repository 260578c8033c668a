"""Plain float32 reference of the shared loop detector: what the port's
``LoopDetector.add_keyframes_batch`` should answer, written from the
description and not from the port's code. It imports nothing of the port
and nothing of JAX; it needs no kernel, cache or batching.

The description it follows (the port's ``FeatureConfig`` /
``LoopDetectorConfig``, the benchmark configuration's ``detector``
section):

* gray = (r + g + b) * f32(1/3); Harris response det − k·tr² of the
  structure tensor (Sobel / 8 gradients, zero padding, each product
  averaged over a 5×5 box of zero padding);
* non-maximum suppression: a pixel is kept where its response equals the
  maximum over the (2·nms_radius + 1)² window (−inf outside the image);
  kept also only inside the border and above ``min_response`` × the
  frame's peak; the ``max_keypoints`` strongest kept pixels, the lowest
  pixel index first among equal responses (a stable top-K); a keypoint is
  valid where its response is above 0;
* BRIEF-256 on the 5×5 box-blurred gray: bit i is set where the blurred
  value at the keypoint + ``_PAIRS_A[i]`` (clamped to the image) is below
  the one at + ``_PAIRS_B[i]``; bits packed least significant first into
  eight 32-bit words, carried as int32 bit patterns. The pairs are the
  draws of ``numpy.random.RandomState(7).randint(-15, 16, (256, 2))``,
  twice, copied here as constants;
* depth: the keypoint's depth d; it has depth where 0.05 < d < 50 m and
  its 3×3 neighbourhood (edge-replicated) is all above 0 and spreads
  less than ``depth_edge_rel`` × max(d, 0.05); back-projected to
  ((u − cx)·f32(1/fx)·d, (v − cy)·f32(1/fy)·d, d);
* Hamming distance by XOR and popcount; a pair with an invalid side is
  10,000 away; a match is mutual nearest (the lowest index first among
  equal distances, both ways), within ``match_max_hamming``, and its
  distance at most ``match_ratio`` × the second best of its row;
* a keyframe's score against a slot is its count of matches; its
  candidates are the ``max_candidates`` best eligible slots, the lowest
  slot first among equal scores; an eligible slot is live and not of the
  same client within ``min_time_separation`` of sensor time;
* verification: the candidate's points (a) matched to the keyframe's (b)
  where both have depth; 3-point RANSAC over ``ransac_iters`` hypotheses
  (a rigid fit to three correspondences each, the first best by inliers
  within ``ransac_inlier_dist``), refit on its inliers, refit again on
  those, and where at least 4 lie within ``ransac_refine_frac`` of the
  distance, refit on those; its inliers are those of the first refit's
  fit; its spread is √ of the middle eigenvalue of the candidate's inlier
  cloud's covariance; a closure (from the candidate to the keyframe,
  T_from_to mapping the keyframe's camera into the candidate's) needs a
  score of ``min_match_score``, ``min_inliers`` inliers and a spread of
  ``min_inlier_spread``;
* the pool: ``max_keyframes`` slots, the lowest free slot first; when
  full, the oldest keyframe of the most represented client (the incoming
  keyframe counted with its client; the lowest client id among equals,
  the lowest slot among equally old) is evicted. A sub-batch's members
  are matched against the pool as it stood before the sub-batch and then
  stored one by one.

Departures, each deliberate: RANSAC takes its triples from the
detector's described stream (``draws``: a generator seeded from the
keyframes ingested before the sub-batch), so that the reference and the
port fit the same triples; a ``numpy`` generator draws them uniformly
among the valid correspondences instead (the tests); the rigid fit is
the SVD of the cross-covariance; in a precision below float32 (the
lower-precision control) the 3×3 SVD, determinant and eigenvalues are
taken in float32 of the rounded inputs and rounded back, since torch has
no such decompositions in bfloat16. Arithmetic order in the filters is
the description's (each term scaled, then summed in row-major window
order), so on one device float32 results equal the port's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Tensor = torch.Tensor

N_BITS = 256
N_WORDS = N_BITS // 32
BIG = 10_000          # the distance of a pair with an invalid side
# the BRIEF pairs as (du, dv), 256 rows each
_PAIRS_A = (
    0, -11, 10, 7, -12, 4, 8, -8, 13, 10, -1, 8, -7, 10, -1, -5, 11, -7, -8,
    -9, -11, 1, -8, -3, -15, -4, 8, 11, -9, 4, 13, -3, -10, 9, 9, 8, 6, 1, 12,
    14, -15, -13, 9, -6, -1, -9, -11, -1, -6, 8, -12, -12, -7, 4, 1, -14, -15,
    1, 7, 14, -3, 13, 13, -8, 8, -5, -6, -12, -15, 14, -8, 8, 13, 8, -15, 6,
    -11, -12, -14, -12, 12, 12, -14, 4, 12, -11, 4, -14, 12, 15, 10, -10, -6,
    14, 2, -13, 4, 3, 3, 6, 8, -12, -4, 11, 0, 1, -3, 14, -4, -6, -6, -3, -12,
    -1, -1, 13, 5, 6, 13, 0, 12, -12, 1, -11, -4, -7, 11, 11, 7, -4, 0, 8, -2,
    3, -8, -12, 14, -3, -3, 0, 14, -7, 7, -9, 6, -9, 6, -3, 12, -8, 2, -5, 0,
    -10, -11, 5, -6, -6, 14, 11, -15, 13, 15, 7, -13, -3, -9, -7, -13, 12, -5,
    -1, 5, 2, 14, -9, -5, 2, -10, 0, 2, 7, -3, -6, -7, 13, 7, 0, -10, -6, 8,
    6, -11, 12, -3, -6, -4, -9, 9, -14, 6, 6, 15, -4, 13, 9, 4, 8, 8, 10, -3,
    -3, -2, -11, -8, 6, 11, -6, -9, 0, -4, 12, 3, 13, 1, -10, -12, -2, -15, 6,
    8, -14, -2, -7, 5, 12, -1, -2, -6, -5, -15, -13, 1, 8, -9, 3, -6, -6, -2,
    6, -4, -14, -1, 1, 1, 10, 2, -1, -14, 6, 4, 3, -15, -2, 11, -5, 15, 5, 11,
    12, 13, -7, 8, -14, -11, 10, -3, 15, 4, 7, -5, 13, -8, 2, 0, -15, 3, -8,
    -3, 1, -15, -3, -6, -1, 9, -13, 1, -4, -10, 6, 1, -6, -4, -5, -15, -7,
    -11, -10, 13, -4, 14, 2, 14, -1, -5, 5, 1, -8, 13, 0, 11, 3, 1, -1, 0, 15,
    15, -2, 4, -6, -2, 9, -12, -8, 2, -5, -15, -14, -4, 12, -11, -9, 14, 12,
    2, 14, 15, -1, -3, -4, -3, 1, 2, 11, 11, -15, 13, -4, -14, -7, 5, 15, -14,
    0, 7, 9, 6, -13, -3, -11, -3, 8, 5, -4, 2, 3, 9, 6, 3, 10, 7, 3, -10, -8,
    8, -10, -10, -9, 14, 1, -5, 7, -1, -11, -1, -9, -2, -13, -3, 7, 9, 14, 12,
    12, 8, 1, -1, 13, -10, -7, 14, -6, -3, 8, -8, -1, -9, 15, -13, -10, 7, 2,
    -1, -6, -12, 0, 5, -15, -12, 6, -9, 5, -15, 5, -14, 6, -13, -4, 0, -4,
    -11, -7, -2, -4, 14, -8, 6, -8, 6, 15, 4, -8, 7, -2, 3, -12, 15, 2, -14,
    -7, 5, 0, -5, 3, 12, 12, 2, 11, -8, -15, -7, -2, 9, -3, 2, -13, -12, 13,
    -15, 11, 2, -4, -14, -10, -10, 7, 1, -6, 12, 4, -4, 3, 5, -13, 0, -7, 11,
    15, 5, 10, 1, -5, -15, 15, 11, -2, -13, 7, 13, -12, -6, 13)
_PAIRS_B = (
    6, 0, 5, -2, -9, -6, -6, -6, -11, -7, -3, -13, -11, 7, -10, 12, 0, -12,
    -10, 3, 7, -1, -1, -11, 4, 3, -3, -10, 10, -1, 8, -10, 9, -4, 11, 6, -13,
    1, -6, 4, -13, 3, -5, -11, -12, -11, -7, -8, -5, 11, 1, -13, -8, 9, -5,
    -7, 14, -11, -15, 5, 2, 8, 5, 13, 14, 10, 1, 2, 1, -5, 7, 15, 3, -15, -13,
    5, 0, 5, 2, -5, -15, -15, -13, -12, 8, 7, 13, -6, -12, 6, -9, -2, 9, 13,
    7, 8, 13, 4, -4, 9, -4, 6, 7, 13, -11, -13, 14, -8, -6, 7, -5, 11, -7, -9,
    11, 2, 1, -8, 7, 9, 6, -11, 15, -1, -12, 1, 8, -1, 13, -3, -11, 1, -7, 11,
    6, 12, -15, 13, -8, -4, 11, -10, -3, -14, 6, 10, 5, 2, 10, 7, 11, 6, -9,
    -4, 9, -10, 10, 15, -11, 14, 7, -15, 7, -13, -5, -2, -12, -14, -9, -8, 1,
    1, -11, 8, -15, 3, -6, -9, 2, -13, -1, -1, -13, -7, -2, 13, -6, 11, -8, 3,
    5, 8, 8, 13, 13, 12, 10, 0, -2, -14, -15, -14, 9, -8, 11, -11, -5, 0, 7,
    -4, -14, 5, -7, 8, -1, 4, 14, 12, -12, -1, 7, 5, 10, 6, 14, 8, 10, -1, 15,
    -5, -3, 10, -1, -2, 8, -9, 10, 9, 12, 9, 7, 12, -13, 3, 3, -4, -10, 2, 5,
    2, -11, 10, 14, -4, -10, 15, 11, -12, 15, -2, -10, 9, -8, 15, -15, -5, -3,
    9, 0, 13, 6, -11, -3, -2, -15, 5, 8, 11, -15, 7, -4, -4, -14, -15, -8, -9,
    1, -12, -9, 8, 15, -11, 12, -7, 15, 11, -1, 8, -6, 7, 4, 11, 12, 10, -13,
    6, -3, 5, -5, 2, -14, -10, -3, 2, 3, -2, 2, 8, -1, 2, -13, -7, 7, -2, 15,
    0, -10, 7, -7, 4, 3, -14, -2, 6, -15, 5, 4, -8, -11, 14, -3, -11, -15,
    -10, -13, 0, 6, 7, -6, 15, 7, 8, 6, 8, -4, 5, -5, -7, -4, 8, -8, 9, -12,
    0, 4, -8, 1, 1, -9, -8, -2, 1, 13, -13, -8, -11, -13, 14, -10, -2, 9, -15,
    6, -12, -4, 0, 11, 14, 0, -11, 6, -1, 12, -3, 9, -5, 12, -15, 6, 10, -2,
    -12, -10, -15, -2, 2, -5, -8, 8, -8, -13, 4, 7, -3, 5, 9, -13, -8, 13,
    -10, -8, 12, 3, 13, -6, -12, -15, 3, 10, -6, 5, 11, 4, -10, 7, 13, -12, 0,
    -7, -11, 12, -7, -14, 5, -13, -1, -4, -2, -7, 6, -4, -15, -5, -6, 9, 2,
    -14, 12, -4, -11, -14, -6, 14, -1, -13, -6, -4, 7, 10, 10, -14, -13, 2,
    -10, 0, 12, -9, 3, -1, 7, 9, 2, 7, 1, 1, -10, 2, -8, 13, 5, 13, -13, 7,
    -11, -1, -14, -8, 4, -15, 9, 2, 7, -5, 1, -6, -15, 8, 4, -4, 11, 4, 3)


def _f32(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Params:
    """Every setting the detector takes, from a configuration's
    ``detector`` section."""
    max_keypoints: int
    harris_k: float
    nms_radius: int
    min_response: float
    border: int
    match_max_hamming: int
    match_ratio: float
    ransac_iters: int
    ransac_inlier_dist: float
    ransac_refine_frac: float
    depth_edge_rel: float
    min_match_score: int
    min_inliers: int
    min_time_separation: float
    max_candidates: int
    min_inlier_spread: float
    max_keyframes: int

    @staticmethod
    def of(detector: dict) -> "Params":
        f = detector["features"]
        kw = {k: f[k] for k in (
            "max_keypoints", "harris_k", "nms_radius", "min_response",
            "border", "match_max_hamming", "match_ratio", "ransac_iters",
            "ransac_inlier_dist", "ransac_refine_frac", "depth_edge_rel")}
        kw.update({k: detector[k] for k in (
            "min_match_score", "min_inliers", "min_time_separation",
            "max_candidates", "min_inlier_spread", "max_keyframes")})
        return Params(**kw)


class Features(NamedTuple):
    uv: Tensor         # (B, K, 2) pixel (u, v)
    valid: Tensor      # (B, K) bool
    desc: Tensor       # (B, K, 8) int32 bit patterns
    p_cam: Tensor      # (B, K, 3) camera-frame points
    has_depth: Tensor  # (B, K) bool


# -- detection and description ---------------------------------------------


def _window(x: Tensor, r: int, pad: float):
    """x (B, H, W) padded by ``pad`` → f(dy, dx) giving the image moved so
    that pixel (i, j) holds x[i + dy, j + dx]."""
    H, W = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (r, r, r, r), value=pad)
    return lambda dy, dx: xp[..., r + dy:r + dy + H, r + dx:r + dx + W]


def box(x: Tensor, r: int) -> Tensor:
    """The mean over a (2r+1)² box, zero outside: each term scaled by
    f32(1 / (2r+1)²), then summed in row-major window order."""
    at = _window(x, r, 0.0)
    w = _f32(1.0 / (2 * r + 1) ** 2)
    out = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            term = at(dy, dx) * w
            out = term if out is None else out + term
    return out


# Sobel / 8 as (dy, dx, weight) in row-major order, zero weights left out
_SOBEL_X = ((-1, -1, -0.125), (-1, 1, 0.125), (0, -1, -0.25), (0, 1, 0.25),
            (1, -1, -0.125), (1, 1, 0.125))
_SOBEL_Y = ((-1, -1, -0.125), (-1, 0, -0.25), (-1, 1, -0.125),
            (1, -1, 0.125), (1, 0, 0.25), (1, 1, 0.125))


def harris(gray: Tensor, k: float) -> Tensor:
    """Harris response of (B, H, W) gray images."""
    at = _window(gray, 1, 0.0)

    def grad(taps):
        out = None
        for dy, dx, w in taps:
            term = at(dy, dx) * w
            out = term if out is None else out + term
        return out

    gx, gy = grad(_SOBEL_X), grad(_SOBEL_Y)
    sxx, syy, sxy = box(gx * gx, 2), box(gy * gy, 2), box(gx * gy, 2)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def features(cam, colors: Tensor, depths: Tensor, p: Params,
             dtype=torch.float32) -> Features:
    """Keypoints of B RGB-D frames: colors (B, H, W, 3) in [0, 1], depths
    (B, H, W) in m, computed in ``dtype``."""
    colors, depths = colors.to(dtype), depths.to(dtype)
    B, H, W = depths.shape
    dev = depths.device
    gray = (colors[..., 0] + colors[..., 1] + colors[..., 2]) * _f32(1 / 3)
    resp = harris(gray, p.harris_k)

    r = p.nms_radius
    at = _window(resp, r, float("-inf"))
    peak_win = resp
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            peak_win = torch.maximum(peak_win, at(dy, dx))
    v = torch.arange(H, device=dev)[:, None]
    u = torch.arange(W, device=dev)[None, :]
    inside = ((u >= p.border) & (u < W - p.border) & (v >= p.border)
              & (v < H - p.border))
    peak = torch.clamp(resp.reshape(B, -1).max(dim=1).values, min=1e-12)
    keep = ((resp >= peak_win) & (resp > (p.min_response * peak)[:, None,
                                                                  None])
            & inside)
    score = torch.where(keep, resp, torch.full_like(resp, -1.0))
    score = score.reshape(B, H * W)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    idx = order[:, :p.max_keypoints]
    top = torch.gather(score, 1, idx)
    ku, kv = idx % W, idx // W
    valid = top > 0

    blur = box(gray, 2).reshape(B, H * W)
    pa = torch.tensor(_PAIRS_A, device=dev).reshape(N_BITS, 2)
    pb = torch.tensor(_PAIRS_B, device=dev).reshape(N_BITS, 2)

    def at_pairs(pairs):
        su = torch.clamp(ku[..., None] + pairs[:, 0], 0, W - 1)
        sv = torch.clamp(kv[..., None] + pairs[:, 1], 0, H - 1)
        flat = (sv * W + su).reshape(B, -1)
        return torch.gather(blur, 1, flat).reshape(B, -1, N_BITS)

    bits = (at_pairs(pa) < at_pairs(pb)).to(torch.int64)
    bits = bits.reshape(B, -1, N_WORDS, 32)
    word = (bits << torch.arange(32, device=dev)).sum(-1)   # < 2**32
    desc = (word - (word >> 31) * (1 << 32)).to(torch.int32)

    flat_d = depths.reshape(B, H * W)

    def depth_at(dv, du):
        sv = torch.clamp(kv + dv, 0, H - 1)
        su = torch.clamp(ku + du, 0, W - 1)
        return torch.gather(flat_d, 1, sv * W + su)

    d = depth_at(0, 0)
    has_depth = valid & (d > 0.05) & (d < 50.0)
    if p.depth_edge_rel > 0:
        around = torch.stack([depth_at(dv, du) for dv in (-1, 0, 1)
                              for du in (-1, 0, 1)], -1)
        spread = around.max(-1).values - around.min(-1).values
        has_depth = (has_depth & (around > 0).all(-1)
                     & (spread < p.depth_edge_rel * torch.clamp(d, min=0.05)))
    uf, vf = ku.to(dtype), kv.to(dtype)
    x = (uf - cam.cx) * _f32(1 / cam.fx) * d
    y = (vf - cam.cy) * _f32(1 / cam.fy) * d
    return Features(uv=torch.stack([uf, vf], -1), valid=valid, desc=desc,
                    p_cam=torch.stack([x, y, d], -1), has_depth=has_depth)


# -- matching ---------------------------------------------------------------

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def popcount64(x: Tensor) -> Tensor:
    """Set bits of each int64 (two's complement), in place of ``x``."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def hamming(a: Tensor, b: Tensor) -> Tensor:
    """Descriptors a (..., Ka, 8) and b (..., Kb, 8) int32 → (..., Ka, Kb)
    int32 Hamming distances: XOR of the 64-bit halves, popcount, sum."""
    a64 = a.contiguous().view(torch.int64)
    b64 = b.contiguous().view(torch.int64)
    d = None
    for w in range(N_WORDS // 2):
        x = popcount64(a64[..., :, None, w] ^ b64[..., None, :, w])
        d = x if d is None else d + x
    return d.to(torch.int32)


def match(a_desc, a_valid, b_desc, b_valid, p: Params) -> Tensor:
    """Mutual nearest matches with the distance and ratio tests of
    descriptor sets a (..., Ka) against b (..., Kb) → (..., Ka) index in b,
    or −1."""
    D = hamming(a_desc, b_desc)
    D = torch.where(a_valid[..., :, None] & b_valid[..., None, :], D, BIG)
    d1, i1 = torch.min(D, dim=-1)            # the first index among ties
    d2 = torch.min(D.scatter(-1, i1[..., None], BIG), dim=-1).values
    back = torch.argmin(D, dim=-2)           # per column, the first row
    rows = torch.arange(D.shape[-2], device=D.device)
    mutual = torch.gather(back, -1, i1) == rows
    ok = (mutual & (d1 <= p.match_max_hamming)
          & (d1.to(torch.float32) <= p.match_ratio * d2.to(torch.float32)))
    return torch.where(ok, i1, -1)


def scores(q: Features, pool_desc: Tensor, pool_valid: Tensor, p: Params,
           chunk: int = 32) -> Tensor:
    """Each of the queries' (Q, K) match counts against every slot of a
    pool (cap, K, 8) → (Q, cap) int64, ``chunk`` slots at a time."""
    out = []
    for s in range(0, pool_desc.shape[0], chunk):
        m = match(q.desc[:, None], q.valid[:, None],
                  pool_desc[None, s:s + chunk], pool_valid[None, s:s + chunk],
                  p)
        out.append((m >= 0).sum(-1))
    return torch.cat(out, dim=1)


def candidates(score: Tensor, eligible: Tensor, n: int):
    """The n best eligible slots of each row, the lowest slot first among
    equal scores → (scores, slots), each (Q, n); an ineligible slot scores
    −1."""
    s = torch.where(eligible, score, -1)
    top, slots = torch.sort(s, dim=-1, descending=True, stable=True)
    return top[..., :n], slots[..., :n]


# -- verification -------------------------------------------------------------


def _svd3(A: Tensor):
    if A.dtype in (torch.float32, torch.float64):
        return torch.linalg.svd(A)
    U, S, Vh = torch.linalg.svd(A.to(torch.float32))
    return U.to(A.dtype), S.to(A.dtype), Vh.to(A.dtype)


def fit(pa: Tensor, pb: Tensor, w: Tensor):
    """The rigid motion (R, t) with pb ≈ R pa + t minimising the w-weighted
    squared error: pa, pb (..., N, 3), w (..., N) → R (..., 3, 3), t
    (..., 3)."""
    sw = torch.clamp(w.sum(-1), min=1e-6)[..., None]
    ca = (w[..., None] * pa).sum(-2) / sw
    cb = (w[..., None] * pb).sum(-2) / sw
    # Σ w (a − ca)(b − cb)ᵀ
    H = (w[..., None] * (pa - ca[..., None, :])).transpose(-1, -2) \
        @ (pb - cb[..., None, :])
    U, _, Vh = _svd3(H)
    V = Vh.transpose(-1, -2)
    s = torch.sign(torch.linalg.det((V @ U.transpose(-1, -2))
                                    .to(torch.float32))).to(H.dtype)
    D = torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device)
    D = torch.cat([D[..., :2], s[..., None]], -1)
    R = (V * D[..., None, :]) @ U.transpose(-1, -2)
    t = cb - (R @ ca[..., None])[..., 0]
    return R, t


def _inliers(R, t, pa, pb, valid, dist):
    moved = (R[..., None, :, :] @ pa[..., None])[..., 0] + t[..., None, :]
    return valid & (torch.linalg.norm(moved - pb, dim=-1) < dist)


def draws(valid: Tensor, iters: int, rng) -> Tensor:
    """RANSAC's triples for the pairs of ``valid`` (P, M) → indices (P,
    iters, 3). With a ``torch.Generator``, the detector's stream: its
    generator (one a sub-batch, seeded with 97 × the keyframes ingested
    before it) draws ``torch.multinomial`` over the pairs' validity as
    float32 (a pair with none valid drawn uniformly), iters × 3 a pair
    with replacement. With a ``numpy`` generator, uniform among the valid
    correspondences."""
    P, M = valid.shape
    if isinstance(rng, torch.Generator):
        w = valid.to(torch.float32)
        w = w + (w.sum(-1, keepdim=True) == 0).to(torch.float32)
        return torch.multinomial(w, iters * 3, replacement=True,
                                 generator=rng).reshape(P, iters, 3)
    ok = valid.cpu().numpy()
    draw = np.zeros((P, iters, 3), np.int64)
    for i in range(P):
        live = np.flatnonzero(ok[i])
        if live.size:
            draw[i] = rng.choice(live, size=(iters, 3))
    return torch.from_numpy(draw).to(valid.device)


def ransac(pa: Tensor, pb: Tensor, valid: Tensor, p: Params, rng):
    """3-point RANSAC over correspondences pa → pb (P, M, 3) with ``valid``
    (P, M), its triples from ``draws`` → (R (P, 3, 3), t (P, 3), inliers
    (P, M) bool)."""
    P, M = valid.shape
    idx = draws(valid, p.ransac_iters, rng).long().reshape(P, -1)
    sa = torch.gather(pa, 1, idx[..., None].expand(-1, -1, 3))
    sb = torch.gather(pb, 1, idx[..., None].expand(-1, -1, 3))
    sa = sa.reshape(P, p.ransac_iters, 3, 3)
    sb = sb.reshape(P, p.ransac_iters, 3, 3)
    R, t = fit(sa, sb, torch.ones(sa.shape[:-1], dtype=pa.dtype,
                                  device=pa.device))
    inl = _inliers(R, t, pa[:, None], pb[:, None], valid[:, None],
                   p.ransac_inlier_dist)
    best = torch.argmax(inl.sum(-1), dim=-1)           # the first best
    R0 = R[torch.arange(P), best]
    t0 = t[torch.arange(P), best]
    inl0 = _inliers(R0, t0, pa, pb, valid, p.ransac_inlier_dist)
    R1, t1 = fit(pa, pb, inl0.to(pa.dtype))
    inl1 = _inliers(R1, t1, pa, pb, valid, p.ransac_inlier_dist)
    R2, t2 = fit(pa, pb, inl1.to(pa.dtype))
    if p.ransac_refine_frac > 0:
        tight = _inliers(R2, t2, pa, pb, valid,
                         p.ransac_refine_frac * p.ransac_inlier_dist)
        R3, t3 = fit(pa, pb, tight.to(pa.dtype))
        use = (tight.sum(-1) >= 4)
        R2 = torch.where(use[:, None, None], R3, R2)
        t2 = torch.where(use[:, None], t3, t2)
    return R2, t2, inl1


def spread(pa: Tensor, mask: Tensor) -> Tensor:
    """√ of the middle eigenvalue of the covariance of the points pa (P, M,
    3) where ``mask`` (P, M) → (P,)."""
    w = mask.to(pa.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)[..., None]
    mu = (w[..., None] * pa).sum(-2) / n
    d = (pa - mu[..., None, :]) * w[..., None]
    cov = d.transpose(-1, -2) @ d / n[..., None]
    ev = torch.linalg.eigvalsh(cov.to(torch.float32))
    return torch.sqrt(torch.clamp(ev[..., 1], min=0.0))


def verify(a: Features, b: Features, p: Params, rng):
    """Candidates a against keyframes b, pair by pair (fields (P, K, ...))
    → (T_a_b (P, 4, 4) float32 mapping b's camera into a's, inliers (P,),
    spread (P,), the centroid of b's inlier points (P, 3) float32)."""
    m = match(a.desc, a.valid, b.desc, b.valid, p)
    mc = torch.clamp(m, min=0)
    pb = torch.gather(b.p_cam, 1, mc[..., None].expand(-1, -1, 3))
    ok = (m >= 0) & a.has_depth & torch.gather(b.has_depth, 1, mc)
    R, t, inl = ransac(a.p_cam, pb, ok, p, rng)
    Rf, tf = R.to(torch.float32), t.to(torch.float32)
    T = torch.zeros(R.shape[0], 4, 4, dtype=torch.float32, device=R.device)
    T[:, :3, :3] = Rf.transpose(-1, -2)
    T[:, :3, 3] = -(Rf.transpose(-1, -2) @ tf[..., None])[..., 0]
    T[:, 3, 3] = 1.0
    w = inl.to(torch.float32)
    centre = (w[..., None] * pb.to(torch.float32)).sum(-2) \
        / torch.clamp(w.sum(-1), min=1.0)[..., None]
    return T, inl.sum(-1), spread(a.p_cam, inl), centre


def closes(p: Params, score: int, inliers: int, spread_m: float) -> bool:
    """The gates a verified candidate passes to become a closure."""
    return (score >= p.min_match_score and inliers >= p.min_inliers
            and spread_m >= p.min_inlier_spread)


# -- the pool ---------------------------------------------------------------


class SlotTable:
    """The pool's slots as a plain table: client (−1 where free), sensor
    time and the caller's tag of the frame stored there."""

    def __init__(self, cap: int):
        self.client = np.full(cap, -1, np.int64)
        self.t = np.zeros(cap, np.float64)
        self.tag = np.full(cap, -1, np.int64)
        self.evictions = 0

    def copy(self) -> "SlotTable":
        c = SlotTable(0)
        c.client, c.t, c.tag = self.client.copy(), self.t.copy(), \
            self.tag.copy()
        c.evictions = self.evictions
        return c

    def eligible(self, client: int, t: float, min_sep: float) -> np.ndarray:
        live = self.client >= 0
        near = (self.client == client) & (np.abs(t - self.t) < min_sep)
        return live & ~near

    def store(self, client: int, t: float, tag: int) -> int:
        """Store a keyframe → its slot (evicting where the pool is full)."""
        free = np.flatnonzero(self.client < 0)
        if free.size:
            s = int(free[0])
        else:
            ids = np.unique(np.append(self.client, client))
            n = np.array([(self.client == c).sum() + (c == client)
                          for c in ids])
            order = [int(c) for c in ids[np.argsort(-n, kind="stable")]]
            target = next(c for c in order if (self.client == c).any())
            mine = np.flatnonzero(self.client == target)
            s = int(mine[np.argmin(self.t[mine])])
            self.evictions += 1
        self.client[s], self.t[s], self.tag[s] = client, t, tag
        return s
