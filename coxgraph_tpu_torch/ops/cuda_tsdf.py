"""The projective TSDF block update — the CUDA kernel that replaces the
TPU kernel ``coxgraph_tpu/ops/pallas_tsdf.py::_kernel_ws``, and its plain
torch twin.

``update_blocks`` dispatches by the pools' device: on CUDA tensors it
launches the kernel in ``csrc/tsdf_update.cu`` (or raises), on CPU tensors
it runs ``update_blocks_reference``. There is no fallback from the one to
the other. Both follow the reference's f32 XLA update
(``coxgraph_tpu/ops/tsdf.py::_update_xla``) and share one arithmetic, op
for op, so on the card they agree bit for bit.

Per touched-block lane (``slots``/``slot_mask`` from the allocation pass):
project the block's v³ voxel centres into the frame, round to a pixel,
gather depth and colour, and update pool row ``k·max_blocks + slot`` in
place:

    sdf = D − Z;  observed = D ∈ (min, max) ∧ sdf > −τ
    w_obs = 1/max(D², 1) · clip((sdf + τ)/(τ/2), 0, 1)   (when observed)
    new_w = min(w + w_obs, max_weight)
    sdf  ← (w·sdf + w_obs·clip(sdf, ±τ)) / max(new_w, 1e-9)   if new_w > 0
    rgb  ← (w·rgb + w_obs·(|sdf| < τ)·pixel) / max(new_w, 1e-9) if new_w > 0

Masked lanes leave their rows untouched. The TPU kernel's bf16 depth
split, stride-pyramid atlas and working set are TPU layout devices and are
not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..utils.tensorops import check_operand as _check, f32_reciprocal

Tensor = torch.Tensor

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one launch a call, counted under "k1"
_UPDATE = _build.EntryPoint("k1", "cox_tsdf_update_blocks", (
    [_P] * 10      # pools, coords, k, slots, mask, depth, color, T
    + [_I] * 6     # n_lanes, mb, vps, vec, height, width
    + [_F] * 11    # fx fy cx cy min max tau 1/(tau/2) max_w vs bs
    + [_I, _I]))   # use_dropoff, use_distance_weight


def voxels_per_thread(v3: int) -> int:
    """The kernel's path, by shape alone: 2 voxels per thread in 8-byte
    accesses when a row of v³ f32 is a multiple of 8 bytes (even v), else
    1."""
    return 2 if v3 % 2 == 0 else 1


def update_blocks_reference(spec: vx.VoxelGridSpec, cfg,
                            intr: PinholeIntrinsics, layers: vx.TsdfLayer,
                            k: Tensor, slots: Tensor, slot_mask: Tensor,
                            depth: Tensor, color: Optional[Tensor],
                            T_cam_sm: Tensor) -> None:
    """Plain torch block update, IN PLACE on ``layers``' pools (the twin
    of the kernel; same arguments as ``update_blocks``)."""
    S = layers.sdf.shape[0]
    mb = spec.max_blocks
    v3 = spec.voxels_per_side ** 3
    K = slots.shape[0]
    H, W = intr.height, intr.width
    tau = spec.truncation
    sdf_pool = layers.sdf.view(S * mb, v3)
    w_pool = layers.weight.view(S * mb, v3)
    c_pool = layers.color.view(S * mb, 3 * v3)
    rows = k.long() * mb + slots.long()                        # (K,)

    coords = layers.block_coords.view(S * mb, 3).index_select(0, rows)
    centers = vx.voxel_centers_of_block(spec, coords).reshape(K, v3, 3)
    p_cam = geo.transform_points(T_cam_sm, centers)
    z = p_cam[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = p_cam[..., 0] / zs * intr.fx + intr.cx
    vv = p_cam[..., 1] / zs * intr.fy + intr.cy
    ui = torch.round(u).to(torch.int32)
    vi = torch.round(vv).to(torch.int32)
    in_img = ((z > cfg.min_range) & (ui >= 0) & (ui < W)
              & (vi >= 0) & (vi < H))
    lin = torch.where(in_img, vi * W + ui, 0).long()
    d = depth.reshape(-1)[lin]
    has_depth = in_img & (d > cfg.min_range) & (d < cfg.max_range)

    sdf = d - z
    observed = has_depth & (sdf > -tau)
    w_obs = torch.ones_like(sdf)
    if cfg.use_distance_weight:
        w_obs = w_obs / torch.clamp(d * d, min=1.0)
    if cfg.use_dropoff:
        w_obs = w_obs * torch.clamp((sdf + tau) * f32_reciprocal(0.5 * tau),
                                    0.0, 1.0)
    live = slot_mask[:, None]
    w_obs = torch.where(observed & live, w_obs, 0.0)
    sdf_obs = torch.clamp(sdf, -tau, tau)

    old_sdf = sdf_pool.index_select(0, rows)
    old_w = w_pool.index_select(0, rows)
    new_w = torch.clamp(old_w + w_obs, max=cfg.max_weight)
    denom = torch.clamp(new_w, min=1e-9)
    new_sdf = torch.where(new_w > 0,
                          (old_w * old_sdf + w_obs * sdf_obs) / denom,
                          old_sdf)
    new_sdf = torch.where(live, new_sdf, old_sdf)
    new_w = torch.where(live, new_w, old_w)

    # Masked lanes must not write, and torch has no dropping scatter:
    # each masked lane re-writes the first live lane's row with that
    # lane's values (identical duplicates). With no live lane, lane 0
    # writes its own old row back.
    first = slot_mask.to(torch.int32).argmax()
    src = torch.where(slot_mask,
                      torch.arange(K, device=slots.device), first)
    dst = rows[src]
    sdf_pool.index_copy_(0, dst, new_sdf[src])
    w_pool.index_copy_(0, dst, new_w[src])

    if color is not None:
        c_img = color.reshape(3, H * W)[:, lin].permute(1, 0, 2)  # (K,3,v3)
        near = w_obs * (torch.abs(sdf) < tau)
        old_c = c_pool.index_select(0, rows).view(K, 3, v3)
        new_c = torch.where(
            (new_w > 0)[:, None],
            (old_w[:, None] * old_c + near[:, None] * c_img)
            / denom[:, None],
            old_c)
        new_c = torch.where(live[:, None], new_c, old_c)
        c_pool.index_copy_(0, dst, new_c.reshape(K, 3 * v3)[src])


def update_blocks(spec: vx.VoxelGridSpec, cfg, intr: PinholeIntrinsics,
                  layers: vx.TsdfLayer, k: Tensor, slots: Tensor,
                  slot_mask: Tensor, depth: Tensor, color: Optional[Tensor],
                  T_cam_sm: Tensor) -> None:
    """Update the touched blocks of submap ``k`` of a stacked collection,
    IN PLACE.

    layers: pools (S, mb, v³) / (S, mb, 3·v³) f32, block_coords (S, mb, 3)
    int32; k: () int32 device tensor; slots (K,) int32 (clamped to mb-1)
    and slot_mask (K,) bool from the allocation pass; depth (H, W) f32;
    color planar (3, H, W) f32 in [0, 1] or None; T_cam_sm (7,) f32.

    CUDA tensors launch the kernel (one launch) or raise; CPU tensors run
    ``update_blocks_reference``. The kernel's path follows from the shape
    alone: rows of v³ f32 that are a multiple of 8 bytes (even v) take 2
    voxels per thread in 8-byte accesses, and the pools must then be
    8-byte aligned; other rows (odd v) take 1 voxel per thread."""
    device = layers.sdf.device
    if device.type == "cpu":
        update_blocks_reference(spec, cfg, intr, layers, k, slots,
                                slot_mask, depth, color, T_cam_sm)
        return
    if device.type != "cuda":
        raise ValueError(f"update_blocks runs on cpu or cuda, not {device}")

    S = layers.sdf.shape[0]
    mb = spec.max_blocks
    v = spec.voxels_per_side
    v3 = v ** 3
    K = slots.shape[0]
    H, W = intr.height, intr.width
    f32 = torch.float32
    align = 4 * voxels_per_thread(v3)    # bytes the kernel accesses at once
    for name in ("sdf", "weight"):
        _check(f"layers.{name}", getattr(layers, name), f32, (S, mb, v3),
               device, align=align)
    _check("layers.color", layers.color, f32, (S, mb, 3 * v3), device,
           align=align)
    _check("layers.block_coords", layers.block_coords, torch.int32,
           (S, mb, 3), device)
    _check("k", k, torch.int32, (), device)
    _check("slots", slots, torch.int32, (K,), device)
    _check("slot_mask", slot_mask, torch.bool, (K,), device)
    _check("depth", depth, f32, (H, W), device)
    if color is not None:
        _check("color", color, f32, (3, H, W), device)
    _check("T_cam_sm", T_cam_sm, f32, (7,), device)

    launch(None, spec, cfg, intr, layers, k, slots, slot_mask, depth,
           color, T_cam_sm)


def launch(lib, spec: vx.VoxelGridSpec, cfg, intr: PinholeIntrinsics,
           layers: vx.TsdfLayer, k: Tensor, slots: Tensor,
           slot_mask: Tensor, depth: Tensor, color: Optional[Tensor],
           T_cam_sm: Tensor) -> None:
    """Launch the block update on the current stream, operands unchecked
    (``update_blocks`` checks them); ``lib``: this library, or a build of
    an edited copy of the kernel (tools/time_k1_variants.py)."""
    v = spec.voxels_per_side
    tau = spec.truncation
    _UPDATE(
        layers.sdf.device,
        layers.sdf.data_ptr(), layers.weight.data_ptr(),
        layers.color.data_ptr(), layers.block_coords.data_ptr(),
        k.data_ptr(), slots.data_ptr(), slot_mask.data_ptr(),
        depth.data_ptr(), None if color is None else color.data_ptr(),
        T_cam_sm.data_ptr(), slots.shape[0], spec.max_blocks, v,
        voxels_per_thread(v ** 3),
        intr.height, intr.width, intr.fx, intr.fy, intr.cx, intr.cy,
        cfg.min_range, cfg.max_range, tau, f32_reciprocal(0.5 * tau),
        cfg.max_weight, spec.voxel_size, spec.block_size,
        int(cfg.use_dropoff), int(cfg.use_distance_weight), lib=lib)
