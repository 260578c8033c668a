"""Trajectory evaluation — port of ``coxgraph_tpu.eval.metrics``: ATE/RPE
in the style the reference's TUM-format exports are consumed by
(evo-style ATE on coxgraph_server.cpp:165-179 outputs). Host numpy, the
same code as the JAX package's, so the same inputs give the same
outputs."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import geometry as geo


def associate(stamps_a: np.ndarray, stamps_b: np.ndarray,
              max_dt: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-stamp association → (idx_a, idx_b)."""
    stamps_a = np.asarray(stamps_a)
    stamps_b = np.asarray(stamps_b)
    j = np.searchsorted(stamps_b, stamps_a)
    j = np.clip(j, 1, len(stamps_b) - 1)
    left = stamps_b[j - 1]
    right = stamps_b[j]
    j = np.where(np.abs(stamps_a - left) < np.abs(stamps_a - right), j - 1, j)
    ok = np.abs(stamps_b[j] - stamps_a) <= max_dt
    return np.nonzero(ok)[0], j[ok]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rigid alignment src→dst. Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * np.diag(S)).sum() / (sc ** 2).sum() * src.shape[0]) \
        if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def rpe(stamps_est, poses_est, stamps_gt, poses_gt,
        delta: float = 1.0, max_dt: float = 0.05
        ) -> Tuple[float, float]:
    """Relative pose error over a time delta (TUM-benchmark style; the
    drift-rate complement to ATE for the reference's replay evaluation —
    SURVEY.md §4, coxgraph_server.cpp:165-179 TUM exports).

    For each associated pose pair (i, j) with stamps_est[j] ≈
    stamps_est[i] + delta, the error transform is
    E = (Q_i⁻¹ Q_j)⁻¹ (P_i⁻¹ P_j); returns (trans RMSE in m/delta,
    rot RMSE in rad/delta). Poses are (N,7) [qw qx qy qz t]."""
    ia, ib = associate(stamps_est, stamps_gt, max_dt)
    if len(ia) < 2:
        return float("inf"), float("inf")
    se = np.asarray(stamps_est)[ia]
    pe = np.asarray(poses_est, np.float64)[ia]
    pg = np.asarray(poses_gt, np.float64)[ib]
    j = np.searchsorted(se, se + delta)
    j = np.clip(j, 1, len(se) - 1)
    j = np.where(np.abs(se[j - 1] - (se + delta))
                 < np.abs(se[j] - (se + delta)), j - 1, j)
    ok = (np.abs(se[j] - (se + delta)) <= max_dt) & (j > np.arange(len(se)))
    if not np.any(ok):
        return float("inf"), float("inf")
    i0 = np.nonzero(ok)[0]
    j0 = j[i0]
    terrs, rerrs = [], []
    for a, b in zip(i0, j0):
        d_est = geo.relative_np(pe[a], pe[b])
        d_gt = geo.relative_np(pg[a], pg[b])
        err = geo.relative_np(d_gt, d_est)
        terrs.append(float(np.linalg.norm(err[4:7])))
        w = min(1.0, abs(float(err[0])))
        rerrs.append(2.0 * float(np.arccos(w)))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))


def ate_rmse(stamps_est, poses_est, stamps_gt, poses_gt,
             align: bool = True, max_dt: float = 0.05) -> float:
    """ATE RMSE (m) between trajectories of (N,7) [qw qx qy qz t] poses."""
    pe = np.asarray(poses_est)[:, 4:7]
    pg = np.asarray(poses_gt)[:, 4:7]
    ia, ib = associate(stamps_est, stamps_gt, max_dt)
    if len(ia) == 0:
        return float("inf")
    pe, pg = pe[ia], pg[ib]
    if align and len(ia) >= 3:
        R, t, s = umeyama_alignment(pe, pg)
        pe = (s * (R @ pe.T)).T + t
    return float(np.sqrt(((pe - pg) ** 2).sum(axis=-1).mean()))
