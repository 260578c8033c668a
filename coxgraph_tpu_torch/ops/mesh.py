"""TSDF → triangle mesh extraction — port of ``coxgraph_tpu.ops.mesh``.

Marching tetrahedra over voxel cells: each cube between 8 voxel centres
is split into 6 tetrahedra around its main diagonal, and each
tetrahedron emits 0, 1 or 2 triangles from a 16-case table built in numpy
at import. A chunk of pool slots is meshed as one dense masked batch in
structure-of-arrays form (the cell axis N last), and its triangles are
compacted to the front of a fixed-capacity buffer on the device; whole
extractions append the chunks' runs at a running offset that stays on
the device.

What differs from the reference is only how the device does it:

* the reference's one-hot "table lookup" matmuls are index selections
  here (exact: each one-hot row selects one finite term);
* its ``lax.scan`` over chunks is a Python loop; a chunk's run is
  written at the running offset with ``index_copy_``, so the only host
  reads are the capacity checks of ``extract_mesh`` and the final slice;
* the quantized readback quantizes in int32 on the device (torch's
  uint16 lacks most operations) and casts to uint16 / uint8 on the host;
  rounding is half to even on both sides.

Cross-block cell corners come through the block-index grid, so boundary
cells stitch seamlessly.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import voxel as vx
from ..utils.tensorops import f32_reciprocal, scatter_drop

Tensor = torch.Tensor

# Cube corner offsets (x, y, z), the 6-tetrahedra decomposition around the
# main diagonal c0-c6, and the tet edge list.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int32,
)
_TETS = np.array(
    [
        [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
        [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
    ],
    dtype=np.int32,
)
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)


def _build_tet_table() -> Tuple[np.ndarray, np.ndarray]:
    """Generate the marching-tetrahedra case table.

    Returns (tri_edges (16, 2, 3) int32 edge ids into _TET_EDGES with -1
    padding, n_tris (16,) int32). Case bit i set ⇔ sdf at tet vertex i < 0.
    """
    edge_of_pair = -np.ones((4, 4), dtype=np.int32)
    for e, (a, b) in enumerate(_TET_EDGES):
        edge_of_pair[a, b] = edge_of_pair[b, a] = e

    tri_edges = -np.ones((16, 2, 3), dtype=np.int32)
    n_tris = np.zeros((16,), dtype=np.int32)
    for case in range(16):
        neg = [v for v in range(4) if case & (1 << v)]
        pos = [v for v in range(4) if v not in neg]
        if len(neg) in (1, 3):
            iso = neg[0] if len(neg) == 1 else pos[0]
            others = [v for v in range(4) if v != iso]
            es = [edge_of_pair[iso, o] for o in others]
            tri_edges[case, 0] = es
            n_tris[case] = 1
        elif len(neg) == 2:
            a, b = neg
            c, d = pos
            # quad ring: (a,c) (a,d) (b,d) (b,c) — consecutive edges share
            # a tet vertex, so the quad is planar-ring ordered
            e0, e1, e2, e3 = (
                edge_of_pair[a, c], edge_of_pair[a, d],
                edge_of_pair[b, d], edge_of_pair[b, c],
            )
            tri_edges[case, 0] = [e0, e1, e2]
            tri_edges[case, 1] = [e0, e2, e3]
            n_tris[case] = 2
    return tri_edges, n_tris


_TRI_EDGES_TABLE, _N_TRIS_TABLE = _build_tet_table()

# tet-vertex / tet-edge-endpoint POSITION offsets are the cube corners, so
# vertex positions are a per-cell base plus a constant offset
_T8OFF = _CORNERS[_TETS].astype(np.float32)                    # (6,4,3)
_EAOFF = _CORNERS[_TETS[:, _TET_EDGES[:, 0]]].astype(np.float32)  # (6,6,3)
_EBOFF = _CORNERS[_TETS[:, _TET_EDGES[:, 1]]].astype(np.float32)
# the normal's gradient proxy Σ_v sdf_v (p_v − centroid) sees only the
# constant corner offsets (the base cancels against the centroid)
_GRADW = _T8OFF - _T8OFF.mean(axis=1, keepdims=True)          # (6,4,3)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The case and selection tables on ``device`` (built once per
    device: a host-to-device copy per chunk would stall the loop)."""
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return {
        "tv": t(_TETS.reshape(-1)),                            # (24,)
        "ea": t(_TETS[:, _TET_EDGES[:, 0]].reshape(-1)),       # (36,)
        "eb": t(_TETS[:, _TET_EDGES[:, 1]].reshape(-1)),
        "tri_e": t(np.maximum(_TRI_EDGES_TABLE, 0).reshape(16, 6)),
        "n_tris": t(_N_TRIS_TABLE, torch.float32),
        "bit": t(1 << np.arange(4), torch.int32).reshape(1, 4, 1),
        "tri": t(np.arange(2), torch.float32).reshape(2, 1, 1),
        "off8": t(np.stack(np.meshgrid(*([np.arange(2)] * 3),
                                       indexing="ij"), -1).reshape(8, 3),
                  torch.int32),
        "ea_off": [t(_EAOFF[:, :, k, None], torch.float32)
                   for k in range(3)],
        "e_diff": [t((_EBOFF - _EAOFF)[:, :, k, None], torch.float32)
                   for k in range(3)],
        "gradw": [[t(_GRADW[:, v, k, None], torch.float32)
                   for v in range(4)] for k in range(3)],
    }


def chunk_capacity(spec: vx.VoxelGridSpec, chunk: int,
                   cap_mult: int = 1) -> int:
    """Triangle slots of one chunk's compacted run: 1/16 of the
    theoretical 12 per cell, times ``cap_mult`` (≤ 16 = the maximum)."""
    t_chunk = chunk * spec.voxels_per_side ** 3 * 12
    return min(t_chunk // 16 * cap_mult, t_chunk)


def mesh_block_chunk(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                     slots: Tensor, min_weight: float = 1e-4,
                     cap_mult: int = 1):
    """Extract the triangles of a chunk of pool slots.

    slots: (C,) int32 pool slots (dead slots ≥ num_blocks emit nothing).
    → (verts (9, cap) f32, colors (9, cap) f32, n_valid () int32,
    n_total () int32) with cap = ``chunk_capacity(spec, C, cap_mult)``:
    triangles compacted to the front, in (triangle a, tet q, cell n)
    order; row f = vertex b·3 + coordinate k. ``n_total`` counts every
    valid triangle before the capacity clamp."""
    tb = _tables(slots.device)
    v = spec.voxels_per_side
    C = slots.shape[0]
    N = C * v ** 3
    mb = layer.max_blocks
    sl = torch.clamp(slots, max=mb - 1).long()
    coords = layer.block_coords[sl]                         # (C,3)
    live = slots < layer.num_blocks

    # the 2×2×2 neighbourhood of whole blocks per chunk block, one row
    # gather per field, assembled into (C, 2v, 2v, 2v)
    nb_idx = vx.lookup_block(spec, layer, coords[:, None, :]
                             + tb["off8"][None])            # (C,8)
    safe = torch.clamp(nb_idx, min=0).reshape(-1).long()

    def assemble(rows):
        big = rows.reshape(C, 2, 2, 2, v, v, v).permute(0, 1, 4, 2, 5, 3, 6)
        return big.reshape(C, 2 * v, 2 * v, 2 * v)

    v1 = v + 1
    sdf_g = assemble(layer.sdf[safe])[:, :v1, :v1, :v1]
    w_g = assemble(layer.weight[safe])[:, :v1, :v1, :v1]
    alloc = (nb_idx >= 0).reshape(C, 2, 1, 2, 1, 2, 1).expand(
        C, 2, v, 2, v, 2, v).reshape(C, 2 * v, 2 * v, 2 * v)
    ok_g = (alloc[:, :v1, :v1, :v1] & (w_g > min_weight)
            & live[:, None, None, None])
    col8 = layer.color[safe].reshape(C * 8, 3, v ** 3)
    col_g = [assemble(col8[:, ch])[:, :v1, :v1, :v1] for ch in range(3)]

    def corner_slices(x):
        return torch.stack([
            x[:, cx:cx + v, cy:cy + v, cz:cz + v].reshape(N)
            for cx, cy, cz in _CORNERS.tolist()])           # (8, N)

    cs8 = corner_slices(sdf_g)
    cok = corner_slices(ok_g).all(dim=0)                    # (N,)
    cc8 = [corner_slices(c) for c in col_g]                 # 3×(8,N)

    # per-cell corner-0 world position, one plane per axis
    r = torch.arange(v, dtype=torch.float32, device=slots.device)
    cf = coords.to(torch.float32) * v
    grids = torch.meshgrid(r, r, r, indexing="ij")
    base = [((cf[:, k, None, None, None] + grids[k][None] + 0.5)
             * spec.voxel_size).reshape(N) for k in range(3)]

    ts = cs8[tb["tv"]].reshape(6, 4, N)
    ea = cs8[tb["ea"]].reshape(6, 6, N)
    eb = cs8[tb["eb"]].reshape(6, 6, N)
    case = ((ts < 0).to(torch.int32) * tb["bit"]).sum(dim=1)  # (6,N)
    denom = ea - eb
    t = torch.clamp(ea / torch.where(denom.abs() < 1e-12, 1e-12, denom),
                    0.0, 1.0)                               # (6,6,N)

    vs = spec.voxel_size
    ep = [base[k][None, None, :] + vs * (tb["ea_off"][k]
                                         + t * tb["e_diff"][k])
          for k in range(3)]                                # 3×(6,6,N)
    ec = []
    for k in range(3):
        ca = cc8[k][tb["ea"]].reshape(6, 6, N)
        cb = cc8[k][tb["eb"]].reshape(6, 6, N)
        ec.append(ca + t * (cb - ca))

    # triangle (a, vertex b) of tet q takes the crossing on edge
    # tri_edges[case, a, b]
    sel = tb["tri_e"][case.long()].permute(0, 2, 1).contiguous()  # (6,6,N)

    def edge_select(field):
        return [torch.gather(field[k], 1, sel).reshape(6, 2, 3, N)
                .permute(1, 2, 0, 3) for k in range(3)]     # 3×(2,3,6,N)

    verts = edge_select(ep)
    colsv = edge_select(ec)
    ntri = tb["n_tris"][case.long()]                        # (6,N)
    tri_valid = (tb["tri"] < ntri[None]) & cok[None, None]  # (2,6,N)

    # orient triangles so the normal points toward positive sdf
    gw = tb["gradw"]
    grad = [ts[:, 0] * gw[k][0] + ts[:, 1] * gw[k][1] + ts[:, 2] * gw[k][2]
            + ts[:, 3] * gw[k][3] for k in range(3)]        # 3×(6,N)
    e1 = [verts[k][:, 1] - verts[k][:, 0] for k in range(3)]  # (2,6,N)
    e2 = [verts[k][:, 2] - verts[k][:, 0] for k in range(3)]
    nrm = [e1[1] * e2[2] - e1[2] * e2[1],
           e1[2] * e2[0] - e1[0] * e2[2],
           e1[0] * e2[1] - e1[1] * e2[0]]
    flip = (nrm[0] * grad[0][None] + nrm[1] * grad[1][None]
            + nrm[2] * grad[2][None]) < 0                   # (2,6,N)

    def planes(field):
        out = []
        for b in range(3):
            for k in range(3):
                if b == 0:
                    p = field[k][:, 0]
                elif b == 1:
                    p = torch.where(flip, field[k][:, 2], field[k][:, 1])
                else:
                    p = torch.where(flip, field[k][:, 1], field[k][:, 2])
                out.append(p)
        return torch.stack(out).reshape(9, -1)              # (9, T)

    bigv = planes(verts)
    bigc = planes(colsv)
    out_m = tri_valid.reshape(-1)                           # (T,) [a,q,n]

    # compaction: the source column of each of the first cap triangles
    T_ = out_m.shape[0]
    cap = chunk_capacity(spec, C, cap_mult)
    pos = torch.cumsum(out_m.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(out_m & (pos < cap), pos, cap)
    src = scatter_drop(
        torch.full((cap,), T_, dtype=torch.int32, device=slots.device), tgt,
        torch.arange(T_, dtype=torch.int32, device=slots.device))
    filled = src < T_
    srcg = torch.where(filled, src, 0).long()
    cv = torch.where(filled[None], bigv.index_select(1, srcg), 0.0)
    ccf = torch.where(filled[None], bigc.index_select(1, srcg), 0.0)
    n_total = out_m.sum(dtype=torch.int32)
    return cv, ccf, torch.clamp(n_total, max=cap), n_total


def _append_run(verts_g: Tensor, cols_g: Tensor, off: Tensor, cols_idx:
                Tensor, v: Tensor, col: Tensor, max_tris: int) -> Tensor:
    """Write a chunk's (9, cap) run at the running offset (clamped to
    max_tris; the buffers carry cap columns of slack) → the clamped
    offset. The run's unfilled tail is overwritten by the next chunk."""
    off_c = torch.clamp(off, max=max_tris)
    idx = off_c.long() + cols_idx
    verts_g.index_copy_(1, idx, v)
    cols_g.index_copy_(1, idx, col)
    return off_c


def _buffers(spec: vx.VoxelGridSpec, chunk: int, max_tris: int,
             cap_mult: int, device):
    cap = chunk_capacity(spec, chunk, cap_mult)
    return (torch.zeros((9, max_tris + cap), dtype=torch.float32,
                        device=device),
            torch.zeros((9, max_tris + cap), dtype=torch.float32,
                        device=device),
            torch.arange(cap, device=device))


def dirty_block_chunks(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                       updated: Tensor, chunk: int = 16) -> Tensor:
    """Expand an updated-block bitmap (max_blocks,) to the mesh-DEPENDENT
    block set and reduce it to per-chunk dirty bits →
    (ceil(max_blocks / chunk),) bool. A change to block c invalidates the
    mesh of every block at coords(c) − {0,1}³, whose cells read its
    corners."""
    mb = layer.block_coords.shape[0]
    device = updated.device
    coords = layer.block_coords
    live_upd = updated & (torch.arange(mb, device=device) < layer.num_blocks)
    out = torch.zeros((mb,), dtype=torch.bool, device=device)
    ones = torch.ones((mb,), dtype=torch.bool, device=device)
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                idx = vx.lookup_block(spec, layer,
                                      vx.shift(coords, (-dx, -dy, -dz)))
                ok = live_upd & (idx >= 0)
                # every duplicate target receives the same True
                out = scatter_drop(out, torch.where(ok, idx, mb), ones)
    n_chunks = -(-mb // chunk)
    pad = n_chunks * chunk - mb
    if pad:
        out = torch.cat([out, out.new_zeros((pad,))])
    return out.reshape(n_chunks, chunk).any(dim=1)


def extract_mesh_chunks_device(spec: vx.VoxelGridSpec,
                               layer: vx.TsdfLayer, chunk: int,
                               min_weight: float, max_tris: int,
                               chunk_ids: Tensor, cap_mult: int = 1):
    """Mesh extraction restricted to the given block chunks, chunk after
    chunk, with no host read. chunk_ids: (nc,) int32 on the layer's device
    (chunk c covers slots [c·chunk, (c+1)·chunk)); negative ids emit
    nothing. → (verts, colors (9, max_tris + cap), offs (nc,), cnts (nc,),
    totals (nc,)): chunk i's triangles are columns [offs[i], offs[i] +
    cnts[i]), written at a running offset clamped to max_tris; totals[i]
    counts chunk i's valid triangles before its capacity clamp, so
    totals[i] > cnts[i] means it overflowed (or the buffer filled)."""
    ar = torch.arange(chunk, dtype=torch.int32, device=layer.sdf.device)
    ids = chunk_ids[:, None]
    return _extract_slot_chunks(
        spec, layer, torch.where(ids < 0, layer.max_blocks, ids * chunk + ar),
        min_weight, max_tris, cap_mult)


def _extract_slot_chunks(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                         slots: Tensor, min_weight: float, max_tris: int,
                         cap_mult: int):
    """extract_mesh_chunks_device over explicit slot chunks (nc, chunk);
    slots ≥ max_blocks emit nothing."""
    device = layer.sdf.device
    verts_g, cols_g, cols_idx = _buffers(spec, slots.shape[1], max_tris,
                                         cap_mult, device)
    off = torch.zeros((), dtype=torch.int32, device=device)
    offs, cnts, totals = [], [], []
    for i in range(slots.shape[0]):
        v, col, cnt, n_tot = mesh_block_chunk(spec, layer, slots[i],
                                              min_weight, cap_mult)
        off_c = _append_run(verts_g, cols_g, off, cols_idx, v, col, max_tris)
        off = torch.clamp(off_c + cnt, max=max_tris)
        offs.append(off_c)
        cnts.append(cnt)
        totals.append(n_tot)
    return (verts_g, cols_g, torch.stack(offs), torch.stack(cnts),
            torch.stack(totals))


def extract_mesh_device(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                        min_weight: float = 1e-4, chunk: int = 16,
                        max_tris: int = 2_000_000, slot_base: int = 0,
                        n_slots: Optional[int] = None, cap_mult: int = 1):
    """Mesh extraction over pool slots [slot_base, slot_base + n_slots)
    (default: every slot), with no host read. The sharded extractor
    (parallel.merge_sharded) gives each rank one range.

    → (verts (9, max_tris + cap), colors (9, max_tris + cap), count (),
    total ()): chunk runs front-compacted; ``total`` counts every valid
    triangle before the per-chunk capacity clamp, so total > count means
    some chunk overflowed (or the buffer filled). The range's last chunk
    stops at its end: a range that is not a multiple of ``chunk`` never
    meshes the next range's slots (the JAX package's does)."""
    n = layer.max_blocks if n_slots is None else n_slots
    n_chunks = -(-n // chunk)
    slots = slot_base + torch.arange(n_chunks * chunk, dtype=torch.int32,
                                     device=layer.sdf.device)
    slots = torch.where(slots < slot_base + n, slots, layer.max_blocks)
    verts, cols, offs, cnts, totals = _extract_slot_chunks(
        spec, layer, slots.reshape(n_chunks, chunk), min_weight, max_tris,
        cap_mult)
    return (verts, cols, torch.clamp(offs[-1] + cnts[-1], max=max_tris),
            totals.sum(dtype=torch.int32))


def quantize_mesh_device(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                         verts: Tensor, cols: Tensor):
    """Quantize triangle buffers on the device before the host pull:
    vertices on the layer's live-block AABB grid (uint16 range), colours
    to 0..255, both as int32 (the host casts to uint16 / uint8).
    verts/cols: (9, M) planes. → (qverts (9,M), qcols (9,M), aabb_min
    (3,), scale ())."""
    mb = layer.block_coords.shape[0]
    live = (torch.arange(mb, device=verts.device) < layer.num_blocks)[:, None]
    bc = layer.block_coords
    mn_b = torch.where(live, bc, 1 << 20).amin(dim=0)
    mx_b = torch.where(live, bc, -(1 << 20)).amax(dim=0) + 1
    mn = mn_b.to(torch.float32) * spec.block_size
    mx = mx_b.to(torch.float32) * spec.block_size
    scale = torch.clamp((mx - mn).amax() * f32_reciprocal(65535.0),
                        min=1e-6)
    mn9 = mn.repeat(3)                       # plane f holds coord f % 3
    q = torch.clamp((verts - mn9[:, None]) / scale, 0.0, 65535.0)
    qc = torch.clamp(cols * 255.0, 0.0, 255.0)
    return (torch.round(q).to(torch.int32), torch.round(qc).to(torch.int32),
            mn, scale)


def host_triangles(verts: Tensor, cols: Tensor, n: int, quant=None):
    """The first ``n`` columns of (9, M) triangle planes → (verts (n,3,3),
    colors (n,3,3)) f32 numpy. ``quant`` = (aabb_min, scale) dequantizes
    int32 planes from quantize_mesh_device as uint16 / uint8 values."""
    v = verts[:, :n].cpu().numpy().T
    c = cols[:, :n].cpu().numpy().T
    if quant is not None:
        mn, scale = quant
        v = (v.astype(np.uint16).astype(np.float32) * scale
             + np.tile(mn, 3)[None, :])
        c = c.astype(np.uint8).astype(np.float32) / 255.0
    return (np.ascontiguousarray(v).reshape(-1, 3, 3),
            np.ascontiguousarray(c).reshape(-1, 3, 3))


def host_quant(mn: Tensor, scale: Tensor):
    """(aabb_min (3,) np.float32, scale float) of quantize_mesh_device,
    read in one transfer."""
    h = torch.cat([mn, scale.reshape(1)]).cpu().numpy()
    return h[:3].astype(np.float32), float(h[3])


def extract_mesh(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                 min_weight: float = 1e-4, chunk: int = 16,
                 max_tris: int = 2_000_000, quantize: bool = True):
    """Full-layer mesh extraction → (verts (T,3,3), colors (T,3,3)) numpy.

    ``quantize`` (default) moves the buffers as uint16 vertices on the
    live-block AABB grid and uint8 colours (error ≤ extent/65535/2); pass
    False for the f32 values.

    Capacity heals itself: a chunk that overflows its capacity redoes the
    extraction with the per-chunk capacity doubled (``cap_mult`` ≤ 16, the
    theoretical maximum), and a full buffer grows ``max_tris`` to the true
    count, so the mesh is always complete."""
    cap_mult = 1
    while True:
        verts, cols, cnt, total = extract_mesh_device(
            spec, layer, min_weight, chunk, max_tris, cap_mult=cap_mult)
        k, n_total = (int(x) for x in torch.stack([cnt, total]).cpu())
        if n_total <= k:
            break
        if k >= max_tris:
            # the buffer parked at max_tris: grow to the true count, redo
            max_tris = 1 << (n_total - 1).bit_length()
            continue
        if cap_mult >= 16:   # cap == theoretical max: cannot happen
            warnings.warn(
                f"mesh extraction dropped {n_total - k} triangles at "
                "maximum per-chunk capacity", RuntimeWarning, stacklevel=2)
            break
        cap_mult = min(16, 2 * cap_mult)
    if k == 0:
        z = np.zeros((0, 3, 3), np.float32)
        return z, z.copy()
    if quantize:
        qv, qc, mn, scale = quantize_mesh_device(spec, layer, verts, cols)
        return host_triangles(qv, qc, k, host_quant(mn, scale))
    return host_triangles(verts, cols, k)
