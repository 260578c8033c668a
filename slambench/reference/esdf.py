"""Plain ESDF of a TSDF layer, voxel by voxel: observed voxels inside the
truncation band keep their TSDF value and never change; other observed
voxels start at ±``max_distance`` by the TSDF's sign, unobserved ones at
+``max_distance``; then ceil(max_distance / voxel) + ``extra_iters``
Jacobi sweeps relax every voxel of the allocated blocks against its six
face neighbours (a missing neighbour reads +max_distance):
  d ≥ 0: d ← min(d, min_n(max(d_n, 0) + voxel)),
  d < 0: d ← max(d, max_n(min(d_n, 0) − voxel)),
and the result is clipped to ±max_distance."""

from __future__ import annotations

import math

import torch

FACES = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
         (0, 0, -1))


def esdf(coords, sdf, weight, grid, g, cfg: dict) -> torch.Tensor:
    """coords (n, 3), sdf / weight (n, v³), grid (G³,) → dist (n, v³)."""
    v = g.voxels_per_side
    h, gd = g.grid_dim // 2, g.grid_dim
    dev = sdf.device
    md = cfg["max_distance"]
    r = torch.arange(v, device=dev)
    local = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                        -1).reshape(-1, 3)
    gv = (coords[:, None, :] * v + local[None]).reshape(-1, 3)
    nbr = []
    for off in FACES:
        q = gv + torch.tensor(off, device=dev)
        b = torch.div(q, v, rounding_mode="floor")
        lv = q - b * v
        inside = ((b >= -h) & (b < h)).all(-1)
        bc = torch.clamp(b + h, 0, gd - 1)
        row = torch.where(inside, grid[(bc[:, 0] * gd + bc[:, 1]) * gd
                                       + bc[:, 2]], -1)
        lin = (lv[:, 0] * v + lv[:, 1]) * v + lv[:, 2]
        nbr.append(torch.where(row >= 0, row * v ** 3 + lin, -1))
    s = sdf.reshape(-1)
    observed = weight.reshape(-1) > 1e-6
    band = observed & (s.abs() < g.truncation)
    init = torch.where(band, s, torch.where(s >= 0, md, -md))
    init = torch.where(observed, init, md)
    step = torch.tensor(g.voxel_size, dtype=sdf.dtype)
    d = init
    for _ in range(math.ceil(md / g.voxel_size) + cfg["extra_iters"]):
        pos = torch.full_like(d, md)
        neg = torch.full_like(d, -md)
        for idx in nbr:
            dn = torch.where(idx >= 0, d[torch.clamp(idx, min=0)], md)
            pos = torch.minimum(pos, torch.clamp(dn, min=0.0) + step)
            neg = torch.maximum(neg, torch.clamp(dn, max=0.0) - step)
        d = torch.where(d >= 0, torch.minimum(d, pos), torch.maximum(d, neg))
        d = torch.where(band, init, d)
    return torch.clamp(d, -md, md).reshape(sdf.shape)
