"""Sharded global transform-merge — port of
``coxgraph_tpu.parallel.merge_sharded``: the final-mesh reassembly spread
over the ranks (SURVEY.md §5.7: shard SUBMAPS over the ranks, all-reduce
only the fused voxel pools; the multi-rank form of
ServerVisualizer::getFinalGlobalMesh's per-submap merge loop,
server_visualizer.cpp:67-121 / voxblox mergeLayerAintoLayerB).

Weighted TSDF fusion is associative: merging k posed sources into an
empty destination gives sdf = Σᵢwᵢ·sdfᵢ / Σᵢwᵢ per voxel (and the same for
colour), so the work splits cleanly:

  1. ALIGNED ALLOCATION (replicated): destination blocks are allocated
     from every submap's candidate set in a fixed scan order, so every
     rank holds the same slot ↔ block-coordinate map.
  2. LOCAL ACCUMULATION (sharded): each rank resamples ITS submaps at the
     destination voxel centres (merge_layer_into's sampler, bf16-rounded
     corners) and adds (Σw, Σw·sdf, Σw·colour) into its accumulators.
  3. ONE all_reduce PER FIELD, then the weighted means — the sequential
     merge's result up to float summation order.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import geometry as geo
from ..core import voxel as vx
from ..ops import mesh as mesh_ops
from ..ops.merge import _candidate_dst_blocks, _packed_trilinear
from ..ops.tsdf import touched_block_slots
from .collectives import RobotMesh, gather_rows, psum

Tensor = torch.Tensor


def stack_layers(layers: Sequence[vx.TsdfLayer], spec: vx.VoxelGridSpec,
                 pad_to: Optional[int] = None) -> vx.TsdfLayer:
    """Per-submap layers stacked into one layer with a leading (S,) axis,
    padded with empty layers (num_blocks = 0) up to ``pad_to``."""
    n = len(layers)
    layers = list(layers) + [vx.create_tsdf_layer(spec, layers[0].sdf.device)
                             ] * (max(pad_to or n, n) - n)
    return vx.TsdfLayer(**{f.name: torch.stack([getattr(l, f.name)
                                                for l in layers])
                           for f in dataclasses.fields(vx.TsdfLayer)})


def _unstacked(stacked: vx.TsdfLayer) -> List[vx.TsdfLayer]:
    """Views of each submap of a stacked layer."""
    return [vx.TsdfLayer(**{f.name: getattr(stacked, f.name)[s]
                            for f in dataclasses.fields(stacked)})
            for s in range(stacked.sdf.shape[0])]


def allocate_merged(spec: vx.VoxelGridSpec, sources: Sequence[vx.TsdfLayer],
                    poses: Sequence[Tensor],
                    src_spec: Optional[vx.VoxelGridSpec] = None
                    ) -> vx.TsdfLayer:
    """Deterministic destination allocation from every source's candidate
    blocks (a fixed scan order ⇒ the same pool on every rank)."""
    src_spec = src_spec or spec
    dst = vx.create_tsdf_layer(spec, poses[0].device)
    for src, T in zip(sources, poses):
        cand, cv = _candidate_dst_blocks(spec, src_spec, src, T)
        dst = vx.allocate_blocks(spec, dst, cand, cv)
    return dst


def _accumulate_one(spec: vx.VoxelGridSpec, src_spec: vx.VoxelGridSpec,
                    dst: vx.TsdfLayer, src: vx.TsdfLayer, T_dst_src: Tensor,
                    max_touched: int, acc_w: Tensor, acc_ws: Tensor,
                    acc_wc: Tensor) -> None:
    """Add one source's (w, w·sdf, w·colour) at the destination voxel
    centres into the accumulators, IN PLACE (merge_layer_into's
    resampling)."""
    cand, cv = _candidate_dst_blocks(spec, src_spec, src, T_dst_src)
    slots, smask = touched_block_slots(spec, dst, cand, cv, max_touched)
    K = slots.shape[0]
    sl = slots.long()
    centers = vx.voxel_centers_of_block(spec, dst.block_coords[sl])
    p_src = geo.transform_points(geo.inverse(T_dst_src), centers)
    s_sdf, s_w, s_ok = _packed_trilinear(src_spec, src, p_src)

    v3 = spec.voxels_per_side ** 3
    sv = src_spec.voxels_per_side
    sv3 = sv ** 3
    b, lv = vx.voxel_to_block(src_spec, vx.point_to_voxel(src_spec, p_src))
    bidx = vx.lookup_block(src_spec, src, b).reshape(K, 1, v3)
    lin = ((lv[..., 0] * sv + lv[..., 1]) * sv + lv[..., 2]).reshape(K, 1, v3)
    ch_off = (torch.arange(3, device=lin.device) * sv3).reshape(1, 3, 1)
    c_src = src.color.reshape(-1)[torch.clamp(bidx, min=0).long() * (3 * sv3)
                                  + ch_off + lin]          # (K,3,v³)

    w_in = torch.where((s_ok & smask[:, None, None, None]).reshape(K, v3),
                       s_w.reshape(K, v3), 0.0)
    # slots are unique within one source (masked lanes add 0), so the
    # adds are deterministic
    acc_w.index_add_(0, sl, w_in)
    acc_ws.index_add_(0, sl, w_in * s_sdf.reshape(K, v3))
    acc_wc.index_add_(0, sl, (w_in[:, None] * c_src).reshape(K, 3 * v3))


def _merge(spec: vx.VoxelGridSpec, mesh: RobotMesh,
           sources: Sequence[vx.TsdfLayer], poses: Sequence[Tensor],
           src_spec: Optional[vx.VoxelGridSpec], max_touched: int
           ) -> vx.TsdfLayer:
    src_spec = src_spec or spec
    dst = allocate_merged(spec, sources, poses, src_spec)
    mb, v3 = spec.max_blocks, spec.voxels_per_side ** 3
    acc_w = dst.sdf.new_zeros((mb, v3))
    acc_ws = dst.sdf.new_zeros((mb, v3))
    acc_wc = dst.sdf.new_zeros((mb, 3 * v3))
    for s in mesh.share(len(sources)):
        _accumulate_one(spec, src_spec, dst, sources[s], poses[s],
                        max_touched, acc_w, acc_ws, acc_wc)
    acc_w, acc_ws, acc_wc = (psum(mesh, a) for a in (acc_w, acc_ws, acc_wc))
    live = acc_w > 0
    sdf = torch.where(live, acc_ws / torch.clamp(acc_w, min=1e-9),
                      spec.truncation)
    # colour rows are channel-PLANAR [r(v³), g, b] → tile, not repeat
    w3 = acc_w.repeat(1, 3)
    color = torch.where(w3 > 0, acc_wc / torch.clamp(w3, min=1e-9), 0.0)
    return dataclasses.replace(dst, sdf=sdf, weight=acc_w, color=color)


def merge_submaps_sharded(spec: vx.VoxelGridSpec, mesh: RobotMesh,
                          stacked: vx.TsdfLayer, poses: Tensor,
                          src_spec: Optional[vx.VoxelGridSpec] = None,
                          max_touched: int = 4096) -> vx.TsdfLayer:
    """Distributed merge of S posed submaps (a stacked layer, poses
    (S,7)), the same on every rank: each rank accumulates
    ``mesh.share(S)`` of them. Returns the fused layer, replicated."""
    return _merge(spec, mesh, _unstacked(stacked), list(poses), src_spec,
                  max_touched)


def merge_layers_sharded(spec: vx.VoxelGridSpec, mesh: RobotMesh,
                         layers: List[vx.TsdfLayer], poses,
                         src_spec: Optional[vx.VoxelGridSpec] = None,
                         max_touched: int = 4096) -> vx.TsdfLayer:
    """merge_submaps_sharded over a list of layers and their poses ((7,)
    tensors), unstacked."""
    return _merge(spec, mesh, layers, list(poses), src_spec, max_touched)


def extract_mesh_sharded(spec: vx.VoxelGridSpec, mesh: RobotMesh,
                         layer: vx.TsdfLayer, min_weight: float = 1e-4,
                         chunk: int = 16,
                         max_tris_per_device: int = 250_000):
    """Distributed marching tetrahedra over a (replicated) fused layer:
    each rank meshes one range of ⌈max_blocks / world⌉ pool slots
    (ops.mesh.extract_mesh_device), the counts are gathered, then the
    compacted runs, in rank order. The multi-rank form of voxblox
    MeshIntegrator for the final global mesh.

    → (verts (T,3,3) f32, colors (T,3,3) f32) numpy on every rank, like
    extract_mesh(quantize=False). Capacity heals itself as extract_mesh's
    does: when a range's buffer (``max_tris_per_device``, the starting
    size) or a chunk's capacity overflowed, every rank extracts again with
    the buffer grown to the largest range's count or the chunk capacity
    doubled (the JAX package's extractor keeps the first buffer and drops
    the rest); it warns only if a chunk overflows its largest capacity."""
    mbd = -(-spec.max_blocks // mesh.world)
    max_tris, cap_mult = max_tris_per_device, 1
    while True:
        v, c, n, total = mesh_ops.extract_mesh_device(
            spec, layer, min_weight, chunk, max_tris,
            slot_base=mesh.rank * mbd, n_slots=mbd, cap_mult=cap_mult)
        nt = gather_rows(mesh, torch.stack([n, total])[None], mesh.world,
                         mesh.rank)
        counts, totals = (x.cpu().numpy() for x in nt.T)
        if (totals <= counts).all():
            break
        if counts.max() >= max_tris:
            max_tris = 1 << (int(totals.max()) - 1).bit_length()
            continue
        if cap_mult >= 16:
            warnings.warn(
                f"sharded mesh extraction dropped "
                f"{int((totals - counts).sum())} triangles at the maximum "
                "per-chunk capacity", RuntimeWarning, stacklevel=2)
            break
        cap_mult = min(16, 2 * cap_mult)
    T = int(counts.sum())
    if T == 0:
        z = np.zeros((0, 3, 3), np.float32)
        return z, z.copy()
    k = int(counts[mesh.rank])
    rows = torch.cat([v[:, :k], c[:, :k]]).T                 # (k, 18)
    tris = gather_rows(mesh, rows, T, int(counts[:mesh.rank].sum()))
    tris = tris.cpu().numpy()
    return (np.ascontiguousarray(tris[:, :9]).reshape(-1, 3, 3),
            np.ascontiguousarray(tris[:, 9:]).reshape(-1, 3, 3))
