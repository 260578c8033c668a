"""Global two-phase pose-graph optimization with dense registration —
port of ``coxgraph_tpu.server.global_opt`` (the server's solve).

Phase 1 solves the relative-pose constraints (and height priors) alone;
phase 2 adds the explicit-to-implicit registration residuals of every
overlapping submap pair. Overlap detection is host numpy on the submaps'
AABBs. Phase 2 is one batched pass over all pairs per LM iteration: the
live pool rows [0, R) of every submap are stacked into one (S·R, v³)
field and each pair's points sample it through block-index rows shifted
by j·R, on the card in one kernel launch a pass
(``ops.cuda_registration``). LM iterations run on the device with no
host read; the solve's host reads are the phase-1 result (poses and
cost, one read), the submaps' geometry when no cached AABBs are given
(one read for all submaps), the pair list's upload, and the cost trace
(one read).

The reference pads the submap and pair counts to powers of two for its
compile cache; padded pairs contribute exactly zero, so the port does
not pad.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..ops import cuda_registration
from ..ops import registration as reg
from ..solver import pose_graph as pg
from ..utils.tensorops import host

Tensor = torch.Tensor


def submap_geometry(spec: vx.VoxelGridSpec, layers: Sequence[vx.TsdfLayer]
                    ) -> Tuple[List[np.ndarray], List[int]]:
    """Per-submap AABB of the allocated blocks in the submap frame ((2,3)
    [min; max], zeros when empty) and live block count, for all
    ``layers`` in one device-to-host read."""
    if not layers:
        return [], []
    nb = torch.stack([l.num_blocks for l in layers]).to(torch.int32)
    bc = torch.stack([l.block_coords for l in layers])
    live = (torch.arange(bc.shape[1], device=bc.device)
            < nb[:, None])[..., None]
    big = 1 << 30
    lo = torch.where(live, bc, big).amin(dim=1)
    hi = torch.where(live, bc, -big).amax(dim=1)
    host = torch.cat([lo, hi, nb[:, None]], dim=1).cpu().numpy()
    aabbs, counts = [], []
    for row in host:
        n = int(row[6])
        counts.append(n)
        if n == 0:
            aabbs.append(np.zeros((2, 3), np.float32))
            continue
        aabbs.append(np.stack([
            row[0:3].astype(np.float32) * spec.block_size,
            row[3:6].astype(np.float32) * spec.block_size
            + spec.block_size]))
    return aabbs, counts


def submap_aabb(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer) -> np.ndarray:
    """Axis-aligned bounds of the allocated blocks in the submap frame →
    (2,3) [min; max] (one device-to-host read)."""
    return submap_geometry(spec, [layer])[0][0]


def aabb_overlap(a: np.ndarray, b: np.ndarray, margin: float = 0.0) -> bool:
    return bool(np.all(a[0] - margin <= b[1])
                and np.all(b[0] - margin <= a[1]))


def transformed_aabb(aabb: np.ndarray, T) -> np.ndarray:
    """Conservative world-frame AABB of a posed submap AABB (host math)."""
    T = np.asarray(T)
    corners = np.array([[aabb[i, 0], aabb[j, 1], aabb[k, 2]]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    w = geo._np_quat_rotate(T[None, :4], corners) + T[4:7]
    return np.stack([w.min(0), w.max(0)])


def find_overlapping_pairs(spec: vx.VoxelGridSpec,
                           layers: Sequence[vx.TsdfLayer],
                           poses,
                           skip_adjacent_same_client: Optional[
                               Sequence[Tuple[int, int]]] = None,
                           margin: float = 0.5,
                           aabbs: Optional[Sequence[np.ndarray]] = None,
                           n_blocks: Optional[Sequence[int]] = None,
                           max_pairs: int = 0,
                           ) -> List[Tuple[int, int]]:
    """Candidate registration pairs (i < j) by world-AABB intersection.

    ``poses`` is a tensor or a host array. ``aabbs``/``n_blocks`` (host
    values, parallel to ``layers``) are cached per-submap geometry; with
    both this function reads nothing from the device, without them it
    reads all submaps' geometry at once. A None aabb (a submap without
    cached geometry yet) takes no pairs. ``max_pairs`` keeps the pairs
    of largest intersection volume."""
    n = len(layers)
    poses_np = host(poses)
    if aabbs is None or n_blocks is None:
        g_aabbs, g_counts = submap_geometry(spec, layers)
        aabbs = g_aabbs if aabbs is None else aabbs
        n_blocks = g_counts if n_blocks is None else n_blocks
    boxes = [None if aabbs[k] is None
             else transformed_aabb(aabbs[k], poses_np[k]) for k in range(n)]
    skip = set(skip_adjacent_same_client or [])
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) in skip or (j, i) in skip:
                continue
            if boxes[i] is None or boxes[j] is None:
                continue
            if n_blocks[i] and n_blocks[j] \
                    and aabb_overlap(boxes[i], boxes[j], margin):
                # margin-free intersection volume, the ranking key for
                # max_pairs
                lo = np.maximum(boxes[i][0], boxes[j][0])
                hi = np.minimum(boxes[i][1], boxes[j][1])
                pairs.append((i, j, float(np.prod(np.maximum(hi - lo,
                                                             0.0)))))
    if max_pairs and len(pairs) > max_pairs:
        pairs.sort(key=lambda p: -p[2])
        pairs = sorted(pairs[:max_pairs])
    return [(i, j) for (i, j, _) in pairs]


def evaluate_residuals(poses: Tensor,
                       constraints: pg.RelPoseConstraints) -> np.ndarray:
    """Per-constraint whitened residual norms in insertion order (invalid
    rows are 0), read to the host."""
    r = pg.residuals(poses, constraints)
    return torch.linalg.norm(r, dim=-1).cpu().numpy()


def _candidate_stats(spec: vx.VoxelGridSpec, layer_j: vx.TsdfLayer,
                     pts: Tensor, sdf_i: Tensor, mask_i: Tensor,
                     T_i_j: Tensor) -> Tensor:
    """(mean squared masked residual, inlier count) of one candidate as
    one (2,) f32 tensor on the device."""
    r, m = reg.registration_residuals(spec, layer_j, pts, sdf_i, mask_i,
                                      geo.identity(pts.device), T_i_j)
    n = m.sum()
    rms2 = torch.sum(torch.where(m, r * r, 0.0)) / torch.clamp(n, min=1)
    return torch.stack([rms2, n.to(rms2.dtype)])


def _cache(spec, layers, i, cfg, caches):
    """Submap i's (pts, sdf, mask) registration-point cache, read from
    ``caches`` when present and stored there when missing."""
    if caches is not None and caches[i] is not None:
        return caches[i]
    out = reg.surface_point_cache(spec, layers[i], cfg)
    if caches is not None:
        caches[i] = out
    return out


def check_loop_closure_candidates(
        spec: vx.VoxelGridSpec,
        layers: Sequence[vx.TsdfLayer],
        candidates: Sequence[Tuple[int, int, object]],
        cfg: reg.RegistrationConfig = reg.RegistrationConfig(),
        max_rms: float = 0.5,
        min_inliers: int = 30,
        caches: Optional[list] = None,
) -> List[dict]:
    """Verify candidate loop closures by dense TSDF agreement: for each
    (i, j, T_i_j), map submap i's surface points through T_i_j into
    submap j and read j's TSDF there. → one dict per candidate: {i, j,
    rms (in voxels), n_inliers, ok}. ``caches`` (mutable, parallel to
    ``layers``) holds the per-submap registration-point caches, shared
    with the two-phase solve. One two-scalar read per candidate."""
    out = []
    for (i, j, T_i_j) in candidates:
        pts, sdf_i, mask_i = _cache(spec, layers, i, cfg, caches)
        T = torch.as_tensor(np.array(host(T_i_j), np.float32),
                            device=pts.device)
        rms2, n = _candidate_stats(spec, layers[j], pts, sdf_i, mask_i,
                                   T).cpu().numpy()
        n = int(n)
        rms = float(np.sqrt(rms2)) if n else np.inf
        out.append({"i": int(i), "j": int(j), "rms": rms / spec.voxel_size,
                    "n_inliers": n,
                    "ok": bool(n >= min_inliers
                               and rms / spec.voxel_size <= max_rms)})
    return out


def _stack_fields(layers: Sequence[vx.TsdfLayer], R: int):
    """The sampling fields of S submaps as one flat pool → (sdf (S·R, v³),
    weight (S·R, v³), block_index (S, G³) with values remapped to local
    rows [0, R) or -1)."""
    sdf = torch.stack([l.sdf[:R] for l in layers])
    w = torch.stack([l.weight[:R] for l in layers])
    v3 = sdf.shape[-1]
    bi = torch.stack([l.block_index.reshape(-1) for l in layers])
    bi = torch.where((bi >= 0) & (bi < R), bi, -1)
    return sdf.reshape(-1, v3), w.reshape(-1, v3), bi


@dataclasses.dataclass
class RegistrationPair:
    i: int
    j: int
    pts_i: Tensor     # surface samples of submap i (its frame)
    sdf_i: Tensor
    mask_i: Tensor


def make_registration_pairs(spec: vx.VoxelGridSpec,
                            layers: Sequence[vx.TsdfLayer],
                            pairs: Sequence[Tuple[int, int]],
                            cfg: reg.RegistrationConfig,
                            caches: Optional[list] = None,
                            ) -> List[RegistrationPair]:
    """``caches`` (mutable, len == len(layers)) holds per-submap (pts,
    sdf, mask) registration-point caches, filled lazily here."""
    out = []
    for (i, j) in pairs:
        pts, sdf, mask = _cache(spec, layers, i, cfg, caches)
        out.append(RegistrationPair(i=i, j=j, pts_i=pts, sdf_i=sdf,
                                    mask_i=mask))
    return out


def _phase2_funcs(spec: vx.VoxelGridSpec,
                  constraints: pg.RelPoseConstraints,
                  solver_cfg: pg.SolverConfig, fixed_all: Tensor,
                  sdf_flat: Tensor, w_flat: Tensor, bi: Tensor,
                  pair_i: Tensor, pair_j: Tensor,
                  pts: Tensor, sdfA: Tensor, maskA: Tensor,
                  w2: float, huber_delta: float,
                  heights: Optional[pg.HeightConstraints]):
    """The (step, total_cost) closures of the joint phase-2 LM: the
    relative-pose constraints plus the dense registration residuals of
    ALL pairs, each pair's terms scaled by w2 / its inlier count. A step
    that raises the combined cost is rejected and the damping raised,
    so the cost trace never increases.

    Shapes: pair_i/j (P,), pts (P,Q,3), sdfA/maskA (P,Q)."""
    n = fixed_all.shape[0]

    def pair_terms(cur_poses, cost_only=False):
        Hs, bs, costs, nins = cuda_registration.pair_terms(
            spec, sdf_flat, w_flat, bi, pair_j, pts, sdfA, maskA,
            pg._gather(cur_poses, pair_i), pg._gather(cur_poses, pair_j),
            huber_delta, cost_only=cost_only)
        scale = w2 / torch.clamp(nins.to(costs.dtype), min=1.0)
        c_reg = torch.sum(costs * scale)
        if cost_only:
            return c_reg
        return Hs * scale[:, None, None], bs * scale[:, None], c_reg

    def assemble(cur_poses):
        H, b, c_rel = pg._build_normal_equations(cur_poses, constraints,
                                                 solver_cfg, fixed_all,
                                                 heights)
        Hs, bs, c_reg = pair_terms(cur_poses)
        pi, pj = pair_i, pair_j
        H = H + pg.scatter_blocks(
            n, torch.cat([pi, pi, pj, pj]), torch.cat([pi, pj, pi, pj]),
            torch.cat([Hs[:, :6, :6], Hs[:, :6, 6:], Hs[:, 6:, :6],
                       Hs[:, 6:, 6:]]))
        b = b + pg.scatter_rows(n, torch.cat([pi, pj]),
                                torch.cat([bs[:, :6], bs[:, 6:]]))
        # re-apply the gauge zeroing to the rows registration touched
        H, b = pg.gauge_fix(H, b, torch.repeat_interleave(fixed_all, 6))
        return H, b, c_rel + c_reg

    def total_cost(cur_poses):
        return pg._total_cost(cur_poses, constraints, solver_cfg,
                              heights) + pair_terms(cur_poses, cost_only=True)

    def step(cur_poses, lam):
        H, b, cost = assemble(cur_poses)
        delta = pg.damped_solve(H, b, lam)
        trial = pg._apply_delta(cur_poses, delta, solver_cfg)
        accept = total_cost(trial) < cost
        cur_poses = torch.where(accept, trial, cur_poses)
        return cur_poses, pg.lm_update(accept, lam, solver_cfg), cost

    return step, total_cost


def _phase2_chunk(spec, poses, lam, constraints, solver_cfg, n_iters,
                  fixed_all, *field_args, heights=None):
    """``n_iters`` phase-2 LM iterations from the (poses, lam) carry →
    (poses, lam, cost_trace (n_iters,)), all on the device."""
    step, _ = _phase2_funcs(spec, constraints, solver_cfg, fixed_all,
                            *field_args, heights)
    trace = []
    for _ in range(n_iters):
        poses, lam, cost = step(poses, lam)
        trace.append(cost)
    return poses, lam, torch.stack(trace)


def _phase2_final_cost(spec, poses, constraints, solver_cfg, fixed_all,
                       *field_args, heights=None) -> Tensor:
    """Combined (relpose + weighted registration) cost at ``poses``."""
    _, total_cost = _phase2_funcs(spec, constraints, solver_cfg, fixed_all,
                                  *field_args, heights)
    return total_cost(poses)


def optimize_two_phase(poses: Tensor,
                       constraints: pg.RelPoseConstraints,
                       spec: vx.VoxelGridSpec,
                       layers: Sequence[vx.TsdfLayer],
                       reg_cfg: reg.RegistrationConfig =
                       reg.RegistrationConfig(),
                       solver_cfg: pg.SolverConfig = pg.SolverConfig(),
                       registration_weight: float = 30.0,
                       reg_iterations: int = 6,
                       fixed: Optional[Tensor] = None,
                       skip_pairs: Optional[Sequence[Tuple[int, int]]] = None,
                       reg_caches: Optional[list] = None,
                       heights: Optional[pg.HeightConstraints] = None,
                       submap_aabbs: Optional[Sequence[np.ndarray]] = None,
                       submap_blocks: Optional[Sequence[int]] = None,
                       max_pairs: int = 0,
                       stack_cache: Optional[dict] = None,
                       ) -> Tuple[Tensor, dict]:
    """Phase 1: LM over the relative-pose constraints (and optional
    height priors). Phase 2: joint LM adding the registration residuals
    of the overlapping pairs, ``reg_iterations`` iterations in chunks of
    ``reg_cfg.phase2_dispatch_iters`` (0 ⇒ one chunk; the result does not
    depend on it). → (poses, info) with ``phase1_cost``,
    ``n_registration_pairs`` and, after phase 2, ``phase2_relpose_cost``
    and ``phase2_cost_trace`` (the combined cost before each iteration
    and the final one).

    ``submap_aabbs``/``submap_blocks``: host-cached per-submap geometry;
    ``reg_caches``: per-submap registration-point caches; ``stack_cache``:
    a caller-owned dict holding the stacked field across solves (keyed on
    the layers' identities)."""
    n = poses.shape[0]
    device = poses.device
    with runtime.span("opt.phase1"):
        res1 = pg.optimize(poses, constraints, solver_cfg, fixed=fixed,
                           heights=heights)
        poses = res1.poses
        # one read: the phase-1 poses (for the overlap test) and its cost
        host = torch.cat([poses.reshape(-1), res1.cost.reshape(1)]).cpu()
    info = {"phase1_cost": float(host[-1]), "n_registration_pairs": 0}
    if registration_weight == 0.0:
        # zero-weight registration contributes nothing to the solve
        return poses, info

    with runtime.span("opt.pairs"):
        pairs_idx = find_overlapping_pairs(
            spec, layers, host[:-1].reshape(n, 7).numpy(),
            skip_adjacent_same_client=skip_pairs, aabbs=submap_aabbs,
            n_blocks=submap_blocks, max_pairs=max_pairs)
        rpairs = make_registration_pairs(spec, layers, pairs_idx, reg_cfg,
                                         caches=reg_caches)
    info["n_registration_pairs"] = len(rpairs)
    runtime.count("opt.registration_pairs", len(rpairs))
    if not rpairs:
        return poses, info

    ij = torch.as_tensor(np.ascontiguousarray(
        np.array(pairs_idx, np.int64).T)).to(device)
    pair_i, pair_j = ij[0], ij[1]
    if fixed is None:
        fixed = pg.default_fixed(n, device)
    # poses no constraint, prior or pair touches are held constant
    touched = pg.touched_poses(n, constraints, heights)
    touched = touched.index_fill(0, ij.reshape(-1), True)
    fixed_all = fixed | ~touched

    R = min(reg_cfg.max_reg_blocks, spec.max_blocks)
    key = (R, tuple(id(l.sdf) for l in layers))
    if stack_cache is not None and stack_cache.get("key") == key:
        sdf_flat, w_flat, bi = stack_cache["fields"]
    else:
        runtime.count("opt.stack_misses")
        with runtime.span("opt.stack"):
            sdf_flat, w_flat, bi = _stack_fields(layers, R)
        if stack_cache is not None:
            stack_cache["key"] = key
            stack_cache["fields"] = (sdf_flat, w_flat, bi)
            # the key holds ids: keep the keyed tensors alive, so no new
            # layer can take a cached one's id while the entry stands
            stack_cache["keyed"] = [l.sdf for l in layers]
    pts = torch.stack([p.pts_i for p in rpairs])
    sdfA = torch.stack([p.sdf_i for p in rpairs])
    maskA = torch.stack([p.mask_i for p in rpairs])
    field_args = (sdf_flat, w_flat, bi, pair_i, pair_j, pts, sdfA, maskA,
                  float(registration_weight) ** 2, reg_cfg.huber_delta)

    di = reg_cfg.phase2_dispatch_iters
    chunk = reg_iterations if di <= 0 else min(di, reg_iterations)
    lam = torch.full((), solver_cfg.damping_init, dtype=poses.dtype,
                     device=device)
    traces = []
    done = 0
    with runtime.span("opt.phase2"):
        while done < reg_iterations:
            it = min(chunk, reg_iterations - done)
            poses, lam, tr = _phase2_chunk(spec, poses, lam, constraints,
                                           solver_cfg, it, fixed_all,
                                           *field_args, heights=heights)
            traces.append(tr)
            done += it
    runtime.count("opt.phase2_iterations", done)
    with runtime.span("opt.phase2_tail"):
        final_cost = _phase2_final_cost(spec, poses, constraints,
                                        solver_cfg, fixed_all, *field_args,
                                        heights=heights)
        relpose = pg._total_cost(poses, constraints, solver_cfg, heights)
        # one read: the cost trace, the final cost and the relpose cost
        tail = torch.cat(traces + [final_cost.reshape(1),
                                   relpose.reshape(1)]).cpu().tolist()
    info["phase2_relpose_cost"] = tail[-1]
    info["phase2_cost_trace"] = tail[:-1]
    return poses, info
