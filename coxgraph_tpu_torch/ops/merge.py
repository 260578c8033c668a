"""Transform-and-fuse of TSDF layers — port of ``coxgraph_tpu.ops.merge``.

Resampling, not voxel-list iteration: the destination voxel centres of
every touched destination block are transformed into the source frame,
the source TSDF is sampled trilinearly and weighted running averages fuse
the samples into the destination pool. Each live source block
conservatively allocates an n³ neighbourhood of destination blocks around
its transformed AABB.

The reference packs (sdf, weight) as two bf16 halves of one uint32 to
halve its gathers; that rounding is part of the result, so the port
rounds each sampled sdf and weight through bf16 (``_bf16``) and keeps the
pools as they are.
"""

from __future__ import annotations

import torch

from ..core import geometry as geo
from ..core import voxel as vx
from ..utils.tensorops import f32_reciprocal, put_rows, scatter_drop
from .tsdf import touched_block_slots

Tensor = torch.Tensor


def _bf16(x: Tensor) -> Tensor:
    """x rounded to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _candidate_dst_blocks(dst_spec: vx.VoxelGridSpec,
                          src_spec: vx.VoxelGridSpec, src: vx.TsdfLayer,
                          T_dst_src: Tensor):
    """→ (coords (S·n³, 3) int32, valid (S·n³,) bool): destination block
    coordinates covering each live source block. A rotated source block's
    AABB spans ≤ src_block·√3, hence ≤ floor(src_block·√3/dst_block) + 2
    destination blocks per axis (3 when the specs agree)."""
    s_src, s_dst = src_spec.block_size, dst_spec.block_size
    n_off = int(s_src * (3.0 ** 0.5) / s_dst) + 2
    device = src.sdf.device
    live = torch.arange(src.max_blocks, device=device) < src.num_blocks
    origin = vx.block_origin(src_spec, src.block_coords)      # (S,3)
    u = torch.arange(2, dtype=torch.float32, device=device)
    corners = torch.stack(torch.meshgrid(u, u, u, indexing="ij"),
                          dim=-1).reshape(8, 3) * s_src        # (8,3)
    pts_dst = geo.transform_points(T_dst_src,
                                   origin[:, None, :] + corners[None])
    bmin = torch.floor(pts_dst.amin(dim=1)
                       * f32_reciprocal(s_dst)).to(torch.int32)
    r = torch.arange(n_off, dtype=torch.int32, device=device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    cand = bmin[:, None, :] + offs[None]                       # (S,n³,3)
    valid = live[:, None].expand(cand.shape[:2])
    return cand.reshape(-1, 3), valid.reshape(-1)


def _packed_trilinear(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                      p: Tensor):
    """Trilinear (sdf, weight, valid) at world points (...,3) with every
    corner's sdf and weight rounded through bf16 (the reference's packed
    pool); invalid points read (truncation, 0)."""
    v0, corners = vx.trilinear_corners(spec, p)
    sdf_acc = torch.zeros(p.shape[:-1], dtype=torch.float32,
                          device=p.device)
    w_acc = torch.zeros_like(sdf_acc)
    valid = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for off, wt in corners:
        s, w, ok = vx.voxel_lookup(spec, layer, vx.shift(v0, off))
        w = _bf16(w)
        sdf_acc = sdf_acc + wt * _bf16(s)
        w_acc = w_acc + wt * w
        valid = valid & ok & (w > 0)
    return (torch.where(valid, sdf_acc, spec.truncation),
            torch.where(valid, w_acc, 0.0), valid)


def count_touched_dst_blocks(dst_spec: vx.VoxelGridSpec,
                             src: vx.TsdfLayer,
                             src_spec: vx.VoxelGridSpec,
                             T_dst_src: Tensor) -> Tensor:
    """() int32 — how many distinct destination blocks the merge's
    candidate set covers."""
    cand, valid = _candidate_dst_blocks(dst_spec, src_spec, src, T_dst_src)
    g3 = dst_spec.grid_dim ** 3
    slot = vx.block_grid_slot(dst_spec, cand)
    ok = valid & vx.block_in_grid(dst_spec, cand)
    # every duplicate target receives the same True
    bm = scatter_drop(torch.zeros((g3,), dtype=torch.bool,
                                  device=cand.device),
                      torch.where(ok, slot, g3), torch.ones_like(ok))
    return bm.sum(dtype=torch.int32)


def merge_layer_into_sized(spec: vx.VoxelGridSpec, dst: vx.TsdfLayer,
                           src: vx.TsdfLayer, T_dst_src: Tensor,
                           src_spec: vx.VoxelGridSpec = None,
                           min_bucket: int = 256) -> vx.TsdfLayer:
    """merge_layer_into with max_touched sized to the counted candidate
    cover (next power of two, at least ``min_bucket``): one scalar read
    per merge, and the merge's sampling work scales with max_touched."""
    n = int(count_touched_dst_blocks(spec, src, src_spec or spec,
                                     T_dst_src))
    mt = max(min_bucket, 1 << max(n - 1, 1).bit_length())
    return merge_layer_into(spec, dst, src, T_dst_src,
                            min(mt, dst.max_blocks), src_spec)


def merge_layer_into(spec: vx.VoxelGridSpec, dst: vx.TsdfLayer,
                     src: vx.TsdfLayer, T_dst_src: Tensor,
                     max_touched: int = 4096,
                     src_spec: vx.VoxelGridSpec = None) -> vx.TsdfLayer:
    """Fuse ``src`` (posed by T_dst_src) into ``dst`` IN PLACE and return
    ``dst``. ``src_spec`` (default: ``spec``) allows a source of another
    resolution: the destination is resampled at its own grid."""
    src_spec = src_spec or spec
    cand, cand_valid = _candidate_dst_blocks(spec, src_spec, src, T_dst_src)
    alloc = vx.allocate_blocks(spec, dst, cand, cand_valid)
    for name in ("block_index", "block_coords", "num_blocks"):
        getattr(dst, name).copy_(getattr(alloc, name))

    slots, slot_mask = touched_block_slots(spec, dst, cand, cand_valid,
                                           max_touched)
    K = slots.shape[0]
    sl = slots.long()
    centers = vx.voxel_centers_of_block(spec, dst.block_coords[sl])
    p_src = geo.transform_points(geo.inverse(T_dst_src), centers)
    s_sdf, s_w, s_ok = _packed_trilinear(src_spec, src, p_src)
    # nearest-voxel colour from the source's planar rows
    v3 = spec.voxels_per_side ** 3                 # dst voxels per block
    sv = src_spec.voxels_per_side
    sv3 = sv ** 3
    b, lv = vx.voxel_to_block(src_spec, vx.point_to_voxel(src_spec, p_src))
    bidx = vx.lookup_block(src_spec, src, b).reshape(K, 1, v3)
    lin = ((lv[..., 0] * sv + lv[..., 1]) * sv + lv[..., 2]).reshape(K, 1, v3)
    ch_off = (torch.arange(3, device=lin.device) * sv3).reshape(1, 3, 1)
    c_src = src.color.reshape(-1)[torch.clamp(bidx, min=0).long() * (3 * sv3)
                                  + ch_off + lin]          # (K,3,v³)

    s_sdf = s_sdf.reshape(K, v3)
    w_in = torch.where((s_ok & slot_mask[:, None, None, None]).reshape(K, v3),
                       s_w.reshape(K, v3), 0.0)
    old_sdf = dst.sdf[sl]                                  # (K,v³)
    old_w = dst.weight[sl]
    old_c = dst.color[sl].reshape(K, 3, v3)
    new_w = old_w + w_in
    den = torch.clamp(new_w, min=1e-9)
    new_sdf = torch.where(new_w > 0, (old_w * old_sdf + w_in * s_sdf) / den,
                          old_sdf)
    new_c = torch.where(
        (new_w > 0)[:, None],
        (old_w[:, None] * old_c + w_in[:, None] * c_src) / den[:, None],
        old_c).reshape(K, 3 * v3)
    put_rows(dst.sdf, slots, slot_mask, new_sdf)
    put_rows(dst.weight, slots, slot_mask, new_w)
    put_rows(dst.color, slots, slot_mask, new_c)
    return dst

