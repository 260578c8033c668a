"""Plain two-phase global solve of the collaborative server: the
semantics that ``CoxgraphServer.optimize`` has to reproduce, written out
again in plain PyTorch with automatic differentiation for every Jacobian.

Variables: one pose T_k per submap, moved by right-multiplicative
tangents T_k·exp(δ_k), δ = [w, v].

Phase 1 (pose graph): relative-pose terms r = S·log(T_m⁻¹·T_i⁻¹·T_j),
cost ½Σ|r|², ``iterations`` Levenberg-Marquardt steps.

Phase 2 (dense registration): the submap pairs whose world boxes overlap
(with a margin) after phase 1, except a robot's consecutive submaps; each
pair (A, B) takes A's ``max_points`` best surface voxels (weight above
``min_weight``, |sdf| below ``band``·τ, ranked by weight with a fixed
hash jitter) and the residual r = sdf_B(T_B⁻¹·T_A·p) − sdf_A(p), sdf_B
read by trilinear interpolation of B's first ``max_reg_blocks`` pool rows
(all eight corners observed), Huber-weighted at ``huber_delta``; a pair's
terms are scaled by w² / (its valid points). ``PHASE2_ITERATIONS`` LM
steps on the sum of both kinds of terms.

LM step: (H + λ·diag(max(diag H, 1e-8)))·δ = −b; accepted when the cost
falls, λ ×``damping_down`` then, ×``damping_up`` otherwise, clipped to
[1e-9, 1e6]. Fixed poses (the gauge, and poses no term touches) do not
move.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from . import geometry as geo

Tensor = torch.Tensor
HASH = 2654435761
# phase 2's LM steps: fixed in the server (no setting of its own)
PHASE2_ITERATIONS = 6


@dataclasses.dataclass
class Submap:
    """One submap as the solve sees it: its grid (cell → row), block
    coordinates of its allocated rows, and the rows' sdf and weight."""

    client: int
    grid: Tensor        # (G³,) int64, −1 where unallocated
    coords: Tensor      # (n, 3) int64
    sdf: Tensor         # (n, v³)
    weight: Tensor      # (n, v³)


def _lin_solve(A: Tensor, b: Tensor) -> Tensor:
    dt = A.dtype
    up = dt if dt == torch.float64 else torch.float32
    L, info = torch.linalg.cholesky_ex(A.to(up))
    x = torch.cholesky_solve(b.to(up)[:, None], L)[:, 0]
    return torch.where(info == 0, x, float("nan")).to(dt)


class Problem:
    def __init__(self, cfg: dict, submaps: List[Submap], poses: Tensor,
                 constraints: List[Tuple[int, int, Tensor, Tensor]],
                 fixed: int, skip: set, dtype=torch.float32):
        self.cfg, self.submaps, self.dt = cfg, submaps, dtype
        self.poses0 = poses.to(dtype)
        dev = poses.device
        self.dev = dev
        self.ci = torch.tensor([c[0] for c in constraints], device=dev)
        self.cj = torch.tensor([c[1] for c in constraints], device=dev)
        self.Tm = torch.stack([c[2] for c in constraints]).to(dev, dtype)
        self.S = torch.stack([c[3] for c in constraints]).to(dev, dtype)
        self.n = poses.shape[0]
        self.fixed_pose = fixed
        self.skip = skip
        g = cfg["tsdf"]
        self.vs, self.vps = g["voxel_size"], g["voxels_per_side"]
        self.gd, self.tau = g["grid_dim"], g["truncation"]
        # 1/voxel rounded to float32: a division by a constant is a product
        self.inv_vs = float(torch.tensor(1.0 / self.vs, dtype=torch.float32))

    # -- relative-pose terms -------------------------------------------------

    def _rel(self, poses: Tensor, d: Tensor = None) -> Tensor:
        Ti, Tj = poses[self.ci], poses[self.cj]
        if d is not None:
            Ti = geo.compose(Ti, geo.se3_exp(d[:, :6]))
            Tj = geo.compose(Tj, geo.se3_exp(d[:, 6:]))
        err = geo.compose(geo.inverse(self.Tm), geo.relative(Ti, Tj))
        return (self.S @ geo.se3_log(err)[..., None])[..., 0]

    def _rel_terms(self, poses: Tensor):
        d = torch.zeros((self.ci.shape[0], 12), dtype=self.dt,
                        device=self.dev, requires_grad=True)
        with torch.enable_grad():
            r = self._rel(poses, d)
            J = torch.stack([torch.autograd.grad(r[:, a].sum(), d,
                                                 retain_graph=True)[0]
                             for a in range(6)], dim=1)     # (M, 6, 12)
        r = r.detach()
        return r, J, 0.5 * torch.sum(r * r)

    # -- registration terms ------------------------------------------------

    def _sample(self, field, j: Tensor, p: Tensor):
        """Trilinear sdf at points p (P, Q, 3) of field ``j[p]`` of
        ``field`` = (grids (S, G³) with rows past the field's own −1,
        sdf (S·R·v³,), weight (S·R·v³,), R) → (sdf, valid)."""
        grid, sdf, w, R = field
        x = p * self.inv_vs - 0.5
        v0 = torch.floor(x).detach().to(torch.int64)
        f = x - v0.to(x.dtype)
        vps, h, g3 = self.vps, self.gd // 2, self.gd ** 3
        jj = j.reshape((-1,) + (1,) * (p.dim() - 2))
        acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
        ok = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    vv = torch.stack([v0[..., 0] + dx, v0[..., 1] + dy,
                                      v0[..., 2] + dz], -1)
                    b = torch.div(vv, vps, rounding_mode="floor")
                    lv = vv - b * vps
                    inside = ((b >= -h) & (b < h)).all(-1)
                    bc = torch.clamp(b + h, 0, self.gd - 1)
                    cell = (bc[..., 0] * self.gd + bc[..., 1]) * self.gd \
                        + bc[..., 2]
                    row = torch.where(inside, grid.reshape(-1)[jj * g3
                                                               + cell], -1)
                    has = row >= 0
                    lin = (lv[..., 0] * vps + lv[..., 1]) * vps + lv[..., 2]
                    flat = torch.where(has, (jj * R + row) * vps ** 3 + lin,
                                       0)
                    s = torch.where(has, sdf[flat].to(p.dtype), self.tau)
                    ww = torch.where(has, w[flat], 0.0)
                    a = [f[..., k] if (dx, dy, dz)[k] else 1 - f[..., k]
                         for k in range(3)]
                    acc = acc + a[0] * a[1] * a[2] * s
                    ok = ok & has & (ww > 0)
        return acc, ok

    def surface_points(self, k: int):
        """Submap k's registration points → (pts (Q, 3), sdf (Q,), mask)."""
        rc = self.cfg["registration"]
        s = self.submaps[k]
        v3 = self.vps ** 3
        surf = (s.weight > rc["min_weight"]) & \
            (torch.abs(s.sdf) < rc["band"] * self.tau)
        score = torch.where(surf, s.weight, -1.0).reshape(-1).to(
            torch.float32)
        idx = torch.arange(score.shape[0], dtype=torch.int64,
                           device=score.device)
        jit = (((idx * HASH) & 0xFFFFFFFF) >> 8).to(torch.float32) \
            * (1.0 / (1 << 24))
        score = torch.where(score > 0, score * (1.0 + 1e-3 * jit), score)
        top, order = torch.sort(score, descending=True, stable=True)
        Q = rc["max_points"]
        top, order = top[:Q], order[:Q]
        if top.shape[0] < Q:
            pad = Q - top.shape[0]
            top = torch.cat([top, top.new_full((pad,), -1.0)])
            order = torch.cat([order, order.new_zeros(pad)])
        blk, lin = order // v3, order % v3
        local = torch.stack([lin // (self.vps ** 2), (lin // self.vps)
                             % self.vps, lin % self.vps], -1)
        pts = (s.coords[blk].to(self.dt) * (self.vs * self.vps)
               + (local.to(self.dt) + 0.5) * self.vs)
        own = (s.grid[None], s.sdf.reshape(-1), s.weight.reshape(-1),
               s.sdf.shape[0])
        sA, ok = self._sample(own, torch.zeros(1, dtype=torch.int64,
                                               device=self.dev), pts[None])
        ok = ok[0] & (top > 0)
        return pts, torch.where(ok, sA[0], 0.0), ok

    def aabb(self, k: int) -> Tensor:
        c = self.submaps[k].coords.to(self.dt) * (self.vs * self.vps)
        return torch.stack([c.min(0).values,
                            c.max(0).values + self.vs * self.vps])

    def pairs(self, poses: Tensor) -> List[Tuple[int, int]]:
        boxes = []
        for k in range(len(self.submaps)):
            a = self.aabb(k)
            corners = torch.stack([torch.stack([a[i, 0], a[j, 1], a[l, 2]])
                                   for i in (0, 1) for j in (0, 1)
                                   for l in (0, 1)])
            wc = geo.transform_points(poses[k][None], corners)
            boxes.append((wc.min(0).values, wc.max(0).values))
        m = 0.5
        out = []
        for i in range(len(boxes)):
            for j in range(i + 1, len(boxes)):
                if (i, j) in self.skip:
                    continue
                if bool(torch.all(boxes[i][0] - m <= boxes[j][1])
                        and torch.all(boxes[j][0] - m <= boxes[i][1])):
                    out.append((i, j))
        return out

    def _reg(self, poses: Tensor, d: Tensor = None):
        TA = poses[self.pi][:, None]
        TB = poses[self.pj][:, None]
        pts = self.pts
        if d is not None:
            TA = geo.compose(TA, geo.se3_exp(d[..., :6]))
            TB = geo.compose(TB, geo.se3_exp(d[..., 6:]))
        pB = geo.transform_points(geo.inverse(TB),
                                  geo.transform_points(TA, pts))
        s, ok = self._sample(self.fields, self.pj, pB)
        ok = ok & self.maskA
        return torch.where(ok, s - self.sdfA, 0.0), ok

    def _reg_weights(self, r, ok):
        hd = self.cfg["registration"]["huber_delta"]
        w = torch.clamp(hd / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
        w = torch.where(ok, w, 0.0)
        scale = self.w2 / torch.clamp(ok.sum(-1).to(r.dtype), min=1.0)
        return w, scale

    def _reg_cost(self, poses):
        r, ok = self._reg(poses)
        w, scale = self._reg_weights(r, ok)
        return torch.sum(scale * 0.5 * torch.sum(w * r * r, -1))

    def _reg_terms(self, poses: Tensor):
        P, Q = self.pts.shape[:2]
        d = torch.zeros((P, Q, 12), dtype=self.dt, device=self.dev,
                        requires_grad=True)
        with torch.enable_grad():
            r, ok = self._reg(poses, d)
            J = torch.autograd.grad(r.sum(), d)[0]          # (P, Q, 12)
        r = r.detach()
        w, scale = self._reg_weights(r, ok)
        J = torch.where(ok[..., None], J, 0.0)
        wJ = w[..., None] * J
        H = torch.einsum("pqa,pqb->pab", wJ, J) * scale[:, None, None]
        b = torch.einsum("pq,pqa->pa", r, wJ) * scale[:, None]
        cost = torch.sum(scale * 0.5 * torch.sum(w * r * r, -1))
        return H, b, cost

    # -- Levenberg-Marquardt ------------------------------------------------

    def _system(self, poses: Tensor, with_reg: bool):
        n = self.n
        H = torch.zeros((n, 6, n, 6), dtype=self.dt, device=self.dev)
        b = torch.zeros((n, 6), dtype=self.dt, device=self.dev)
        r, J, cost = self._rel_terms(poses)
        Ji, Jj = J[..., :6], J[..., 6:]
        for (a, Ja), (c, Jc) in [((self.ci, Ji), (self.ci, Ji)),
                                 ((self.ci, Ji), (self.cj, Jj)),
                                 ((self.cj, Jj), (self.ci, Ji)),
                                 ((self.cj, Jj), (self.cj, Jj))]:
            self._add(H, a, c, torch.einsum("mra,mrb->mab", Ja, Jc))
        b.index_add_(0, self.ci, torch.einsum("mra,mr->ma", Ji, r))
        b.index_add_(0, self.cj, torch.einsum("mra,mr->ma", Jj, r))
        if with_reg:
            Hp, bp, creg = self._reg_terms(poses)
            for (a, sa), (c, sc) in [((self.pi, 0), (self.pi, 0)),
                                     ((self.pi, 0), (self.pj, 6)),
                                     ((self.pj, 6), (self.pi, 0)),
                                     ((self.pj, 6), (self.pj, 6))]:
                self._add(H, a, c, Hp[:, sa:sa + 6, sc:sc + 6])
            b.index_add_(0, self.pi, bp[:, :6])
            b.index_add_(0, self.pj, bp[:, 6:])
            cost = cost + creg
        H = H.reshape(6 * n, 6 * n)
        b = b.reshape(6 * n)
        fm = torch.repeat_interleave(self.frozen, 6)
        H = torch.where(fm[:, None] | fm[None, :], 0.0, H) \
            + torch.diag(fm.to(self.dt))
        return H, torch.where(fm, 0.0, b), cost

    @staticmethod
    def _add(H: Tensor, rows: Tensor, cols: Tensor, blk: Tensor) -> None:
        n = H.shape[0]
        flat = H.permute(0, 2, 1, 3).reshape(n * n, 6, 6)
        flat.index_add_(0, rows * n + cols, blk)
        H.copy_(flat.reshape(n, n, 6, 6).permute(0, 2, 1, 3))

    def _cost(self, poses: Tensor, with_reg: bool) -> Tensor:
        r = self._rel(poses)
        c = 0.5 * torch.sum(r * r)
        return c + self._reg_cost(poses) if with_reg else c

    def _lm(self, poses: Tensor, iters: int, with_reg: bool) -> Tensor:
        sc = self.cfg["solver"]
        lam = sc["damping_init"]
        trace = self.info.setdefault("phase2_cost_trace" if with_reg
                                     else "phase1_cost_trace", [])
        for _ in range(iters):
            H, b, cost = self._system(poses, with_reg)
            trace.append(float(cost))
            A = H + lam * torch.diag(torch.clamp(torch.diagonal(H),
                                                 min=1e-8))
            delta = _lin_solve(A, -b).reshape(-1, 6)
            trial = geo.compose(poses, geo.se3_exp(delta))
            accept = bool(self._cost(trial, with_reg) < cost)
            if accept:
                poses = trial
            lam = min(max(lam * (sc["damping_down"] if accept
                                 else sc["damping_up"]), 1e-9), 1e6)
        return poses

    def _touched(self, extra=()) -> Tensor:
        t = torch.zeros(self.n, dtype=torch.bool, device=self.dev)
        t[self.ci] = True
        t[self.cj] = True
        for idx in extra:
            t[idx] = True
        return t

    def solve(self, poses: Tensor = None) -> Tensor:
        """Both phases from ``poses`` (default the initial ones)."""
        poses = (self.poses0 if poses is None else poses).to(self.dt)
        self.info = {}
        anchor = torch.zeros(self.n, dtype=torch.bool, device=self.dev)
        anchor[self.fixed_pose] = True
        self.frozen = anchor | ~self._touched()
        poses = self._lm(poses, self.cfg["solver"]["iterations"], False)
        self.info["phase1_cost"] = float(self._cost(poses, False))
        pairs = self.pairs(poses)
        self.info["n_registration_pairs"] = len(pairs)
        if not pairs:
            return poses
        self.pi = torch.tensor([p[0] for p in pairs], device=self.dev)
        self.pj = torch.tensor([p[1] for p in pairs], device=self.dev)
        self.frozen = anchor | ~self._touched((self.pi, self.pj))
        self._prepare_pairs(pairs)
        poses = self._lm(poses, PHASE2_ITERATIONS, True)
        self.info["phase2_cost_trace"].append(float(self._cost(poses, True)))
        return poses

    def _prepare_pairs(self, pairs) -> None:
        rc = self.cfg["registration"]
        R = min(rc["max_reg_blocks"], self.cfg["tsdf"]["max_blocks"])
        cache = {}
        for i, _ in pairs:
            if i not in cache:
                cache[i] = self.surface_points(i)
        self.pts = torch.stack([cache[i][0] for i, _ in pairs])
        self.sdfA = torch.stack([cache[i][1] for i, _ in pairs])
        self.maskA = torch.stack([cache[i][2] for i, _ in pairs])
        v3 = self.vps ** 3
        S = len(self.submaps)
        grid = torch.full((S, self.gd ** 3), -1, dtype=torch.int64,
                          device=self.dev)
        sdf = torch.zeros((S, R, v3), dtype=self.submaps[0].sdf.dtype,
                          device=self.dev)
        w = torch.zeros_like(sdf)
        for k, s in enumerate(self.submaps):
            m = min(s.sdf.shape[0], R)
            grid[k] = torch.where(s.grid < R, s.grid, -1)
            sdf[k, :m] = s.sdf[:m]
            w[k, :m] = s.weight[:m]
        self.fields = (grid, sdf.reshape(-1), w.reshape(-1), R)
        self.w2 = float(self.cfg["server"]["registration_weight"]) ** 2
