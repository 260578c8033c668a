"""The allocation pass of the projective TSDF integrator — two CUDA kernels
(``csrc/tsdf_alloc.cu``) and their plain torch version.

For one frame: backproject a strided pixel grid at a few depths spanning
the truncation band, take the K = min(max_touched_blocks, max_blocks)
smallest touched block cells, allocate the new ones IN PLACE on submap
``k``'s block_index / block_coords / num_blocks, and return the touched
pool slots in cell order ``(slots (K,) clamped to max_blocks - 1,
slot_mask (K,))``.

``alloc_pass`` dispatches by the device: CUDA tensors launch the two
kernels (or raise), CPU tensors run ``alloc_pass_reference``, the torch
composition the JAX package's XLA pass is written in
(``alloc_candidates_reference``, then ``voxel.allocate_and_slots``). No
TPU kernel is replaced. The kernels repeat the plain version's f32
arithmetic op for op, so the two give the same integers bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..utils.tensorops import (check_operand as _check, decimate,
                               f32_reciprocal, linspace)

Tensor = torch.Tensor

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# two launches a call (the mark and the compaction kernel), counted under
# "alloc"
_ALLOC = _build.EntryPoint("alloc", "cox_tsdf_alloc", (
    [_P] * 3       # depth, T, marks
    + [ctypes.c_int64]   # the bytes of marks
    + [_P] * 7     # index, coords, num_blocks, k, slots, mask, touched
    + [_I] * 8     # height, width, stride, band, gd, mb, vps, lanes
    + [_F] * 10))  # band lo hi step, cx cy 1/fx 1/fy min max 1/vs

_GROUP = 64               # grid cells per summary byte of the scratch
_COMPACT_THREADS = 1024   # threads of the compaction CTA


def marks_layout(grid_dim: int) -> tuple:
    """The kernels' scratch → (cell bytes, summary bytes): one byte per
    grid cell, rounded up to whole 64-cell groups, then one byte per group
    for each of the compaction CTA's 1024 threads' equal share."""
    n_groups = -(-grid_dim ** 3 // _GROUP)
    per_thread = -(-n_groups // _COMPACT_THREADS)
    return n_groups * _GROUP, _COMPACT_THREADS * per_thread


def new_marks(spec: vx.VoxelGridSpec, device) -> Tensor:
    """A zeroed scratch for ``alloc_pass`` on ``device``. Each pass leaves
    it zeroed again, so a caller keeps one for a run of frames on one
    stream."""
    return torch.zeros((sum(marks_layout(spec.grid_dim)),),
                       dtype=torch.uint8, device=device)


def alloc_candidates_reference(spec: vx.VoxelGridSpec, cfg,
                               intr: PinholeIntrinsics, depth: Tensor,
                               T_sm_cam: Tensor):
    """Candidate block cells of one frame → (grid_slots (N,) int32,
    valid (N,)), N = band samples × decimated pixels. Every step runs on
    (B,h,w) component tensors."""
    device = depth.device
    st = cfg.alloc_stride
    d_s = decimate(depth, st)
    valid_s = (d_s > cfg.min_range) & (d_s < cfg.max_range)
    ks = linspace(-spec.truncation, spec.truncation,
                  cfg.alloc_band_samples, device)
    d_samples = d_s[None] + ks[:, None, None]              # (B,h,w)
    u = (torch.arange(intr.width, dtype=torch.float32, device=device)[::st]
         - intr.cx) * f32_reciprocal(intr.fx)
    v = (torch.arange(intr.height, dtype=torch.float32, device=device)[::st]
         - intr.cy) * f32_reciprocal(intr.fy)
    dx = u[None, None, :] * d_samples
    dy = v[None, :, None] * d_samples
    R = geo.quat_to_matrix(T_sm_cam[:4])
    t = T_sm_cam[4:7]
    px = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * d_samples + t[0]
    py = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * d_samples + t[1]
    pz = R[2, 0] * dx + R[2, 1] * dy + R[2, 2] * d_samples + t[2]
    inv = 1.0 / spec.voxel_size
    vps = spec.voxels_per_side
    bx = torch.div(torch.floor(px * inv).to(torch.int32), vps,
                   rounding_mode="floor")
    by = torch.div(torch.floor(py * inv).to(torch.int32), vps,
                   rounding_mode="floor")
    bz = torch.div(torch.floor(pz * inv).to(torch.int32), vps,
                   rounding_mode="floor")
    h = spec.half_grid
    gd = spec.grid_dim
    in_grid = ((bx >= -h) & (bx < h) & (by >= -h) & (by < h)
               & (bz >= -h) & (bz < h))
    gx = torch.clamp(bx + h, 0, gd - 1)
    gy = torch.clamp(by + h, 0, gd - 1)
    gz = torch.clamp(bz + h, 0, gd - 1)
    grid_slots = (gx * gd + gy) * gd + gz
    valid = valid_s[None] & (d_samples > cfg.min_range) & in_grid
    return grid_slots.reshape(-1), valid.reshape(-1)


def alloc_pass_reference(spec: vx.VoxelGridSpec, cfg,
                         intr: PinholeIntrinsics, layers: vx.TsdfLayer,
                         k: Tensor, depth: Tensor, T_sm_cam: Tensor,
                         touched: Optional[Tensor] = None):
    """The plain torch pass (same arguments and result as ``alloc_pass``,
    no scratch)."""
    mb = spec.max_blocks
    g3 = spec.grid_dim ** 3
    S = layers.block_index.shape[0]
    kk = k.reshape(1).long()
    bi_all = layers.block_index.view(S, g3)

    grid_slots, cand_valid = alloc_candidates_reference(spec, cfg, intr,
                                                        depth, T_sm_cam)
    K = min(cfg.max_touched_blocks, mb)
    bi_k, bc_k, nb_k, slots, slot_mask = vx.allocate_and_slots(
        spec, bi_all.index_select(0, kk)[0],
        layers.block_coords.index_select(0, kk)[0],
        layers.num_blocks.index_select(0, kk)[0],
        grid_slots, cand_valid, K)
    bi_all.index_copy_(0, kk, bi_k[None])
    layers.block_coords.index_copy_(0, kk, bc_k[None])
    layers.num_blocks.index_copy_(0, kk, nb_k[None])
    if touched is not None:     # the last cell is the drop sentinel
        touched.index_fill_(0, torch.where(slot_mask, slots, mb).long(),
                            True)
    return torch.clamp(slots, max=mb - 1), slot_mask


def alloc_pass(spec: vx.VoxelGridSpec, cfg, intr: PinholeIntrinsics,
               layers: vx.TsdfLayer, k: Tensor, depth: Tensor,
               T_sm_cam: Tensor, touched: Optional[Tensor] = None,
               marks: Optional[Tensor] = None):
    """Allocate the blocks one frame's truncation band touches in submap
    ``k`` of a stacked collection, IN PLACE, → (slots (K,) int32 clamped
    to max_blocks - 1, slot_mask (K,) bool), K = min(max_touched_blocks,
    max_blocks).

    layers: block_index (S, g, g, g), block_coords (S, mb, 3), num_blocks
    (S,), all int32; k: () int32 device tensor; depth (H, W) f32; T_sm_cam
    (7,) f32. ``touched``: a (max_blocks + 1,) bool bitmap into which the
    frame's live slots are ORed (its last cell is the plain version's drop
    sentinel), or None. ``marks``: the kernels' scratch from
    ``new_marks``, which the pass leaves zeroed; required on CUDA, ignored
    on the CPU.

    Every operand is checked (device, dtype, shape, contiguity) on either
    device. CUDA tensors then launch the two kernels (two launches, no
    host read) or raise; CPU tensors run ``alloc_pass_reference`` and
    ignore ``marks``."""
    device = layers.block_index.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"alloc_pass runs on cpu or cuda, not {device}")
    S = layers.block_index.shape[0]
    g, mb = spec.grid_dim, spec.max_blocks
    K = min(cfg.max_touched_blocks, mb)
    i32 = torch.int32
    _check("layers.block_index", layers.block_index, i32, (S, g, g, g),
           device)
    _check("layers.block_coords", layers.block_coords, i32, (S, mb, 3),
           device)
    _check("layers.num_blocks", layers.num_blocks, i32, (S,), device)
    _check("k", k, i32, (), device)
    _check("depth", depth, torch.float32, (intr.height, intr.width), device)
    _check("T_sm_cam", T_sm_cam, torch.float32, (7,), device)
    if touched is not None:
        _check("touched", touched, torch.bool, (mb + 1,), device)
    if device.type == "cpu":
        return alloc_pass_reference(spec, cfg, intr, layers, k, depth,
                                    T_sm_cam, touched)
    if marks is None:
        raise ValueError("alloc_pass on CUDA needs the scratch from "
                         "new_marks")
    _check("marks", marks, torch.uint8, (sum(marks_layout(g)),), device,
           align=16)
    slots = torch.empty((K,), dtype=i32, device=device)
    slot_mask = torch.empty((K,), dtype=torch.bool, device=device)

    band = cfg.alloc_band_samples
    tau = spec.truncation
    _ALLOC(
        device, depth.data_ptr(), T_sm_cam.data_ptr(), marks.data_ptr(),
        marks.numel(), layers.block_index.data_ptr(),
        layers.block_coords.data_ptr(), layers.num_blocks.data_ptr(),
        k.data_ptr(), slots.data_ptr(), slot_mask.data_ptr(),
        None if touched is None else touched.data_ptr(),
        intr.height, intr.width, cfg.alloc_stride, band, g, mb,
        spec.voxels_per_side, K, -tau, tau,
        f32_reciprocal(band - 1) if band > 1 else 0.0,
        intr.cx, intr.cy, f32_reciprocal(intr.fx), f32_reciprocal(intr.fy),
        cfg.min_range, cfg.max_range, 1.0 / spec.voxel_size, launches=2)
    return slots, slot_mask
