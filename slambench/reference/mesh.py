"""Plain marching tetrahedra over a TSDF layer, reduced to what a served
mesh is compared by: per voxel cell (the cube between eight voxel
centres), the number of triangles, the sum of their vertices and the sum
of their vertex colours. Triangle order and orientation do not enter.

A cell is meshed when its eight corners lie in allocated blocks with
weight above ``min_weight``. It splits into six tetrahedra around its
diagonal from corner (0,0,0) to (1,1,1); a tetrahedron whose corners
change sign (negative = sdf < 0) emits one triangle (one or three
negative corners: the three crossings on the edges of the odd corner) or
two (two negative corners a < b, positive c < d: crossings on (a,c),
(a,d), (b,d) and on (a,c), (b,d), (b,c)). A crossing on edge (p, q) sits
at t = clip(s_p / (s_p − s_q), 0, 1) from p, with the colour mixed alike.
"""

from __future__ import annotations

import torch

CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
        (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))


def _crossing_edges(case: int):
    """Edges (as tet-vertex pairs) of the triangles of one sign case,
    each triangle's three edges."""
    neg = [i for i in range(4) if case >> i & 1]
    pos = [i for i in range(4) if not case >> i & 1]
    if len(neg) in (1, 3):
        iso = neg[0] if len(neg) == 1 else pos[0]
        return [[(iso, o) for o in range(4) if o != iso]]
    if len(neg) == 2:
        (a, b), (c, d) = neg, pos
        return [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]
    return []


def corner_fields(coords, sdf, weight, color, grid, g):
    """Per cell of every allocated voxel: the eight corners' (sdf, ok,
    colour (3,)) read through the block grid → lists over corners of
    (n·v³,) tensors, and the cells' global voxel indices (n·v³, 3)."""
    v = g.voxels_per_side
    h, gd = g.grid_dim // 2, g.grid_dim
    dev = sdf.device
    r = torch.arange(v, device=dev)
    local = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                        -1).reshape(-1, 3)
    gv = (coords[:, None, :] * v + local[None]).reshape(-1, 3)
    flat_sdf, flat_w = sdf.reshape(-1), weight.reshape(-1)
    col = color.reshape(color.shape[0], 3, -1)
    out = []
    for off in CORNERS:
        q = gv + torch.tensor(off, device=dev)
        b = torch.div(q, v, rounding_mode="floor")
        lv = q - b * v
        inside = ((b >= -h) & (b < h)).all(-1)
        bc = torch.clamp(b + h, 0, gd - 1)
        row = torch.where(inside, grid[(bc[:, 0] * gd + bc[:, 1]) * gd
                                       + bc[:, 2]], -1)
        has = row >= 0
        lin = (lv[:, 0] * v + lv[:, 1]) * v + lv[:, 2]
        rr = torch.clamp(row, min=0)
        s = flat_sdf[rr * v ** 3 + lin]
        w = flat_w[rr * v ** 3 + lin]
        c = col[rr, :, lin]
        out.append((s, has & (w > 0), w, c))
    return out, gv


def triangles(coords, sdf, weight, color, grid, g, min_weight: float):
    """The layer's triangles → (verts (T, 3, 3), colours (T, 3, 3)), in
    no particular order."""
    corners, gv = corner_fields(coords, sdf, weight, color, grid, g)
    vs = g.voxel_size
    ok = torch.ones_like(corners[0][1])
    for s, has, w, _ in corners:
        ok = ok & has & (w > min_weight)
    base = (gv.to(sdf.dtype) + 0.5) * vs
    vs_out, cs_out = [], []
    for tet in TETS:
        s4 = [corners[c][0] for c in tet]
        case = sum((s4[i] < 0).to(torch.int64) << i for i in range(4))
        cache = {}

        def crossing(p, q):
            if (p, q) not in cache:
                sp, sq = s4[p], s4[q]
                den = sp - sq
                den = torch.where(den.abs() < 1e-12, 1e-12, den)
                t = torch.clamp(sp / den, 0.0, 1.0)
                op = torch.tensor(CORNERS[tet[p]], dtype=sdf.dtype,
                                  device=sdf.device)
                oq = torch.tensor(CORNERS[tet[q]], dtype=sdf.dtype,
                                  device=sdf.device)
                pos = base + vs * (op + t[:, None] * (oq - op))
                cp, cq = corners[tet[p]][3], corners[tet[q]][3]
                cache[(p, q)] = (pos, cp + t[:, None] * (cq - cp))
            return cache[(p, q)]

        for c in range(16):
            tris = _crossing_edges(c)
            sel = ok & (case == c)
            if not tris or not bool(sel.any()):
                continue
            for tri in tris:
                pts = [crossing(*sorted(e)) for e in tri]
                vs_out.append(torch.stack([p[0][sel] for p in pts], 1))
                cs_out.append(torch.stack([p[1][sel] for p in pts], 1))
    if not vs_out:
        z = sdf.new_zeros((0, 3, 3))
        return z, z.clone()
    return torch.cat(vs_out), torch.cat(cs_out)


def quantized(verts, colors, coords, block_size: float):
    """The served mesh's readback applied to a soup: vertices rounded on
    a 16-bit grid over the live blocks' bounding box, colours to 8 bits,
    both in float32 as the port's readback does them."""
    f32 = torch.float32
    mn = coords.min(0).values.to(f32) * block_size
    mx = (coords.max(0).values + 1).to(f32) * block_size
    scale = torch.clamp((mx - mn).amax()
                        * float(torch.tensor(1 / 65535.0, dtype=f32)),
                        min=1e-6)
    q = torch.round(torch.clamp((verts.to(f32) - mn) / scale, 0.0,
                                65535.0))
    c = torch.round(torch.clamp(colors.to(f32) * 255.0, 0.0, 255.0))
    return q * scale + mn, c / 255.0


def cell_key(gv: torch.Tensor) -> torch.Tensor:
    c = gv.to(torch.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def soup_sums(verts, colors, voxel_size: float):
    """A served triangle soup (T, 3, 3) → the same per-cell sums, each
    triangle put in the cell that holds its centroid."""
    cen = verts.mean(dim=1)
    gv = torch.floor(cen / voxel_size - 0.5).to(torch.int64)
    key = cell_key(gv)
    uk, inv = torch.unique(key, return_inverse=True)
    m = uk.numel()
    count = torch.zeros(m, dtype=verts.dtype, device=verts.device)
    count.index_add_(0, inv, torch.ones_like(inv, dtype=verts.dtype))
    vsum = torch.zeros((m, 3), dtype=verts.dtype, device=verts.device)
    vsum.index_add_(0, inv, verts.sum(dim=1))
    csum = torch.zeros((m, 3), dtype=verts.dtype, device=verts.device)
    csum.index_add_(0, inv, colors.sum(dim=1))
    return uk, count, vsum, csum


def compare(test, ref, pos_tol: float, rgb_tol: float) -> dict:
    """Per-cell sums of a served mesh against the reference's → the
    share of cells (meshed on either side) whose triangle count differs,
    or whose vertex sum or colour sum differs by more than the tolerance
    per triangle vertex."""
    kt, nt, vt, ct = test
    kr, nr, vr, cr = ref
    union = torch.unique(torch.cat([kt, kr]))
    m = union.numel()

    def dense(k, n, v, c):
        i = torch.searchsorted(union, k)
        N = torch.zeros(m, dtype=torch.float64, device=union.device)
        V = torch.zeros((m, 3), dtype=torch.float64, device=union.device)
        C = torch.zeros((m, 3), dtype=torch.float64, device=union.device)
        N[i], V[i], C[i] = n.double(), v.double(), c.double()
        return N, V, C

    Nt, Vt, Ct = dense(kt, nt, vt, ct)
    Nr, Vr, Cr = dense(kr, nr, vr, cr)
    per = 3 * torch.maximum(Nr, Nt)
    bad = ((Nt != Nr) | ((Vt - Vr).abs() > pos_tol * per[:, None]).any(-1)
           | ((Ct - Cr).abs() > rgb_tol * per[:, None]).any(-1))
    return {"cells": m, "cells_bad": int(bad.sum()),
            "mesh_mismatch": float(bad.sum()) / max(m, 1)}

