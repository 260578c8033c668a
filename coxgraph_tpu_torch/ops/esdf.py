"""ESDF propagation from a TSDF layer — port of ``coxgraph_tpu.ops.esdf``.

Masked Jacobi distance sweeps over the allocated blocks: every voxel
relaxes against its neighbours (d ← min(d, dₙ + ‖Δ‖), and the mirror for
negative distances) in parallel, cross-block neighbours through the
block-index grid; ceil(max_distance / voxel_size) + extra_iters sweeps
propagate the front that many voxels. The observed TSDF band stays
frozen. Every step is a select, min, max or add of f32 values computed
as the reference computes them, so the result is bit-identical to the
JAX package's.

``esdf_from_tsdf`` dispatches by the layer's device: a CPU layer runs these
plain sweeps (``_esdf_sweeps``), a CUDA layer the kernels of
``ops.cuda_esdf`` over its live blocks, which give the same result bit for
bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .. import runtime
from ..core import voxel as vx
from . import cuda_esdf    # imports this module back: used at call time

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EsdfConfig:
    max_distance: float = 2.0      # m
    full_connectivity: bool = False  # 6-neighbour vs 26-neighbour sweeps
    extra_iters: int = 4


@dataclasses.dataclass
class EsdfLayer:
    """Block-sparse ESDF sharing the parent TSDF's block table; pools are
    flat C-order rows like the TSDF's."""

    dist: Tensor          # (B, v³) signed distance
    observed: Tensor      # (B, v³) bool
    block_index: Tensor   # (G,G,G) int32 — same mapping as the TSDF layer
    block_coords: Tensor  # (B,3)
    num_blocks: Tensor    # ()


def _neighbor_offsets(full: bool) -> np.ndarray:
    if not full:
        return np.array(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]], dtype=np.int32)
    return np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)],
                    dtype=np.int32)


def neighbor_steps(spec: vx.VoxelGridSpec, offs: np.ndarray) -> np.ndarray:
    """‖Δ‖·voxel_size of each offset in f32, as the reference computes it."""
    return (np.sqrt((offs.astype(np.float32) ** 2).sum(axis=-1,
                                                       dtype=np.float32))
            * np.float32(spec.voxel_size)).astype(np.float32)


def sweep_count(spec: vx.VoxelGridSpec, cfg: EsdfConfig) -> int:
    """ceil(max_distance / voxel_size) + extra_iters."""
    return math.ceil(cfg.max_distance / spec.voxel_size) + cfg.extra_iters


AXIS_OFFSETS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1))


def face_neighbor_indices(spec: vx.VoxelGridSpec, block_coords: Tensor,
                          flat_index: Tensor):
    """{axis offset: (B,) slot of the face-neighbour block} (−1 = none)."""
    out = {}
    for off3 in AXIS_OFFSETS:
        nb = vx.shift(block_coords, off3)
        slot = vx.block_grid_slot(spec, nb).long()
        out[off3] = torch.where(vx.block_in_grid(spec, nb),
                                flat_index[slot], -1)
    return out


def axis_neighbor_field(d_src: Tensor, d_own: Tensor, face_idx, off3,
                        v: int, md: float) -> Tensor:
    """The neighbour field along one axis direction: ``d_own`` shifted one
    voxel, with the face plane of the neighbour block (from ``d_src``,
    max_distance where there is none) filling the open side."""
    axis = next(a for a, c in enumerate(off3) if c != 0)
    sign = off3[axis]
    idx = face_idx[off3]
    safe = torch.clamp(idx, min=0).long()
    pl_i = 0 if sign > 0 else v - 1
    ax = axis + 1                                  # voxel axis in d
    plane = d_src.index_select(0, safe).select(ax, pl_i)   # (B, v, v)
    plane = torch.where((idx >= 0)[:, None, None], plane, md).unsqueeze(ax)
    if sign > 0:
        return torch.cat([d_own.narrow(ax, 1, v - 1), plane], dim=ax)
    return torch.cat([plane, d_own.narrow(ax, 0, v - 1)], dim=ax)


def esdf_from_tsdf(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                   cfg: EsdfConfig = EsdfConfig()) -> EsdfLayer:
    """Batch-build the ESDF over the TSDF's allocated blocks, on the
    layer's device, with no host read: the kernels of ``ops.cuda_esdf``
    on CUDA (or a raise), the plain sweeps elsewhere."""
    with runtime.span("esdf.build"):
        if tsdf.sdf.device.type == "cuda":
            out = cuda_esdf.esdf_sweeps(spec, tsdf, cfg)
        else:
            out = _esdf_sweeps(spec, tsdf, cfg)
        runtime.count("esdf.sweeps", sweep_count(spec, cfg))
        return out


def _esdf_sweeps(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                 cfg: EsdfConfig) -> EsdfLayer:
    v = spec.voxels_per_side
    B = tsdf.max_blocks
    device = tsdf.sdf.device
    sdf3 = tsdf.sdf.reshape(B, v, v, v)
    w3 = tsdf.weight.reshape(B, v, v, v)
    live = (torch.arange(B, device=device)
            < tsdf.num_blocks)[:, None, None, None]
    observed = (w3 > 1e-6) & live
    md = cfg.max_distance

    # frozen band: observed voxels inside the truncation band keep their
    # TSDF value; the rest start at ±max_distance by TSDF sign
    band = observed & (sdf3.abs() < spec.truncation)
    init = torch.where(band, sdf3, torch.where(sdf3 >= 0, md, -md))
    init = torch.where(observed, init, md)

    offs = _neighbor_offsets(cfg.full_connectivity)
    step = neighbor_steps(spec, offs)
    n_iters = sweep_count(spec, cfg)
    flat_index = tsdf.block_index.reshape(-1)
    face_idx = face_neighbor_indices(spec, tsdf.block_coords, flat_index)
    offs_py = [tuple(int(c) for c in o) for o in offs.tolist()]

    diag = {}
    if cfg.full_connectivity:
        # flat voxel address of every diagonal neighbour (−1 = none),
        # static across sweeps
        r = torch.arange(v, dtype=torch.int32, device=device)
        ii, jj, kk = torch.meshgrid(r, r, r, indexing="ij")
        local = torch.stack([ii, jj, kk], dim=-1)
        gvox = tsdf.block_coords[:, None, None, None, :] * v + local
        for o in offs_py:
            if sum(abs(c) for c in o) == 1:
                continue
            b, lv = vx.voxel_to_block(spec, vx.shift(gvox, o))
            slot = vx.block_grid_slot(spec, b).long()
            idx = torch.where(vx.block_in_grid(spec, b), flat_index[slot],
                              -1)
            lin = ((torch.clamp(idx, min=0).long() * v + lv[..., 0]) * v
                   + lv[..., 1]) * v + lv[..., 2]
            diag[o] = (idx >= 0, lin)

    d = init
    for _ in range(n_iters):
        pos_best = torch.full_like(d, md)
        neg_best = torch.full_like(d, -md)
        for a, o in enumerate(offs_py):
            if o in diag:
                ok, lin = diag[o]
                dn = torch.where(ok, d.reshape(-1)[lin], md)
            else:
                dn = axis_neighbor_field(d, d, face_idx, o, v, md)
            s = float(step[a])
            pos_best = torch.minimum(pos_best, torch.clamp(dn, min=0.0) + s)
            neg_best = torch.maximum(neg_best, torch.clamp(dn, max=0.0) - s)
        d_new = torch.where(d >= 0, torch.minimum(d, pos_best),
                            torch.maximum(d, neg_best))
        d_new = torch.where(band, init, d_new)        # band frozen
        d = torch.where(live, d_new, md)
    dist = torch.clamp(d, -md, md)
    return EsdfLayer(dist=dist.reshape(B, -1),
                     observed=observed.reshape(B, -1),
                     block_index=tsdf.block_index,
                     block_coords=tsdf.block_coords,
                     num_blocks=tsdf.num_blocks)


def sample_esdf(spec: vx.VoxelGridSpec, esdf: EsdfLayer,
                p: Tensor) -> Tuple[Tensor, Tensor]:
    """Trilinear ESDF lookup at world points (...,3) → (dist, valid)."""
    B = esdf.dist.shape[0]
    tmp = vx.TsdfLayer(
        sdf=esdf.dist, weight=esdf.observed.to(esdf.dist.dtype),
        color=esdf.dist.new_zeros((B, 0)), block_index=esdf.block_index,
        block_coords=esdf.block_coords, num_blocks=esdf.num_blocks)
    d, _, ok = vx.sample_tsdf_trilinear(spec, tmp, p)
    return d, ok


def traversable_points(spec: vx.VoxelGridSpec, esdf: EsdfLayer,
                       robot_radius: float = 0.3):
    """Free-space voxel centres with clearance > robot_radius → (points
    (N,3), mask (N,)) at fixed capacity — the traversability cloud."""
    centers = vx.voxel_centers_of_block(spec, esdf.block_coords)
    free = esdf.observed & (esdf.dist > robot_radius)      # (B, v³)
    live = (torch.arange(esdf.dist.shape[0], device=esdf.dist.device)
            < esdf.num_blocks)
    return centers.reshape(-1, 3), (free & live[:, None]).reshape(-1)
