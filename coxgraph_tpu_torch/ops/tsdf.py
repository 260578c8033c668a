"""Projective TSDF integration of RGB-D frames — port of
``coxgraph_tpu.ops.tsdf``.

Each frame is integrated in two passes:

  1. **Allocation** — backproject a strided pixel grid at a few depths
     spanning the truncation band, dedupe the touched block cells with two
     sorts, allocate new blocks and compact the touched pool slots
     (``_alloc_pass``; integers bit-identical to the JAX package).
  2. **Update** — project the voxel centres of every touched block into
     the frame, gather depth and colour and apply the weighted
     running-average TSDF update (``ops.cuda_tsdf.update_blocks``: the CUDA
     kernel on the GPU, its plain torch twin on the CPU).

A window of frames runs the frames in sequence, with the semantics of the
reference's XLA path: no working-set cap, ``n_union`` is the size of the
window's touched-slot union and ``n_dropped`` is always 0.

The pools of a stacked collection (leading (S,) axis) are addressed
through flat ``(S·max_blocks, ·)`` views with base ``k·max_blocks``; ``k``
and the camera pose stay on the device, so a frame issues no
device-to-host read. All integration functions update ``layers`` IN PLACE
(where the JAX package donated and returned them) and also return it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..utils.tensorops import f32_reciprocal, scatter_drop
from . import cuda_tsdf

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TsdfIntegratorConfig:
    """Static integrator parameters — the JAX package's fields and
    defaults, so configs carry across (``utils.interop.config_from``).

    ``update_chunk_blocks``, ``use_pallas``, ``window_union_blocks`` and
    ``tile_h`` configure the TPU's Pallas path and working set; the GPU
    path reads none of them (one kernel launch covers all touched blocks,
    and a window has no union cap)."""

    max_range: float = 10.0
    min_range: float = 0.1
    max_weight: float = 1.0e4
    max_touched_blocks: int = 2048
    alloc_band_samples: int = 3     # depth samples across the trunc band
    alloc_stride: int = 4           # pixel stride of the allocation pass
    #  (8 is safe at 640×480 — ≥5 samples per block footprint — but
    #   under-allocates at 80×60 test scale; keep 4 as the default)
    use_dropoff: bool = True        # linear weight drop-off behind surface
    use_distance_weight: bool = True  # 1/z² observation weighting
    update_chunk_blocks: int = 512  # unused on the GPU
    use_pallas: Optional[bool] = None  # unused on the GPU
    window_union_blocks: int = 1024  # unused on the GPU
    tile_h: int = 48                # unused on the GPU


def decimate(img: Tensor, st: int) -> Tensor:
    """Top-left stride-``st`` decimation of the last two dims (zero-padded
    to a multiple of ``st`` first, as the reference's reshape form)."""
    if st == 1:
        return img
    H, W = img.shape[-2:]
    ph, pw = (-H) % st, (-W) % st
    if ph or pw:
        img = torch.nn.functional.pad(img, (0, pw, 0, ph))
    s = tuple(img.shape[:-2])
    img = img.reshape(s + ((H + ph) // st, st, (W + pw) // st, st))
    return img[..., :, 0, :, 0]


def color_layout(color: Tensor, height: int, width: int) -> str:
    """Classify a color image layout against the KNOWN intrinsics:
    'planar' for (3, H, W), 'interleaved' for (H, W, 3)."""
    shape = tuple(color.shape)
    if shape == (3, height, width):
        return "planar"
    if shape == (height, width, 3):
        return "interleaved"
    raise ValueError(
        f"color shape {shape} matches neither planar (3, {height}, "
        f"{width}) nor interleaved ({height}, {width}, 3)")


def _linspace(start: float, stop: float, num: int, device) -> Tensor:
    """jnp.linspace(start, stop, num) in its own f32 arithmetic
    (start·(1-s) + stop·s, s = iota·(1/div), with the stop appended), so
    the band samples are the reference's to the bit."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32,
                        device=device) * f32_reciprocal(div)
    lo = torch.full((1,), start, dtype=torch.float32, device=device)
    hi = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([lo * (1 - step) + hi * step, hi])


def _alloc_candidates_soa(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                          intr: PinholeIntrinsics, depth: Tensor,
                          T_sm_cam: Tensor):
    """Pass-1 candidate block cells → (grid_slots (N,) int32, valid (N,)).
    Every step runs on (B,h,w) component tensors."""
    device = depth.device
    st = cfg.alloc_stride
    d_s = decimate(depth, st)
    valid_s = (d_s > cfg.min_range) & (d_s < cfg.max_range)
    ks = _linspace(-spec.truncation, spec.truncation,
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


def touched_block_slots(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                        block_coords: Tensor, valid: Tensor,
                        max_touched: int):
    """Dedupe candidate block coords (N,3) → (slots (K,), mask (K,)): the
    pool slots of the allocated candidates in ascending slot order, K =
    min(max_touched, max_blocks); slots past K are dropped for this call,
    masked lanes hold max_blocks − 1. Used by the layer merge."""
    mb = layer.max_blocks
    K = min(max_touched, mb)
    idx = vx.lookup_block(spec, layer, block_coords)
    ok = valid & (idx >= 0)
    # every duplicate target receives the same True
    touched = scatter_drop(torch.zeros((mb,), dtype=torch.bool,
                                       device=idx.device),
                           torch.where(ok, idx, mb), torch.ones_like(ok))
    pos = torch.cumsum(touched.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(touched & (pos < K), pos, K)
    slots = scatter_drop(torch.full((K,), mb, dtype=torch.int32,
                                    device=idx.device),
                         tgt, torch.arange(mb, dtype=torch.int32,
                                           device=idx.device))
    mask = slots < mb
    return torch.clamp(slots, max=mb - 1), mask


def _alloc_pass(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                intr: PinholeIntrinsics, layers: vx.TsdfLayer, k: Tensor,
                depth: Tensor, T_sm_cam: Tensor):
    """Pass 1 for one frame on the stacked collection: allocate the
    blocks the frame's truncation band touches (IN PLACE on submap ``k``'s
    block_index / block_coords / num_blocks) and compact the touched
    slots → (slots (K,) clamped to max_blocks-1, slot_mask (K,))."""
    mb = spec.max_blocks
    g3 = spec.grid_dim ** 3
    S = layers.block_index.shape[0]
    kk = k.reshape(1).long()
    bi_all = layers.block_index.view(S, g3)

    grid_slots, cand_valid = _alloc_candidates_soa(spec, cfg, intr, depth,
                                                   T_sm_cam)
    K = min(cfg.max_touched_blocks, mb)
    bi_k, bc_k, nb_k, slots, slot_mask = vx.allocate_and_slots(
        spec, bi_all.index_select(0, kk)[0],
        layers.block_coords.index_select(0, kk)[0],
        layers.num_blocks.index_select(0, kk)[0],
        grid_slots, cand_valid, K)
    bi_all.index_copy_(0, kk, bi_k[None])
    layers.block_coords.index_copy_(0, kk, bc_k[None])
    layers.num_blocks.index_copy_(0, kk, nb_k[None])
    return torch.clamp(slots, max=mb - 1), slot_mask


def _mark_touched(touched_ext: Tensor, slots: Tensor, mask: Tensor) -> None:
    """OR a frame's live slots into a (max_blocks + 1,) bitmap whose last
    cell is the drop sentinel."""
    mb = touched_ext.shape[0] - 1
    touched_ext.index_fill_(0, torch.where(mask, slots, mb).long(), True)


def integrate_frame_stacked_impl(spec: vx.VoxelGridSpec,
                                 cfg: TsdfIntegratorConfig,
                                 intr: PinholeIntrinsics,
                                 layers: vx.TsdfLayer, k: Tensor,
                                 depth: Tensor, color: Optional[Tensor],
                                 T_sm_cam: Tensor,
                                 return_stats: bool = False):
    """Integrate one RGB-D frame into submap ``k`` (0-d int32 device
    tensor) of a STACKED collection, IN PLACE.

    depth: (H,W) z-depth (0 = invalid); color: (H,W,3) or (3,H,W) in
    [0,1], or None; T_sm_cam: (7,) camera pose in the submap frame.
    ``return_stats=True`` also returns ``(n_union, n_dropped, updated)``
    as integrate_window_stacked_impl does."""
    return integrate_window_stacked_impl(
        spec, cfg, intr, layers, k, depth[None],
        None if color is None else color[None], T_sm_cam[None],
        return_stats=return_stats)


def integrate_window_stacked_impl(spec: vx.VoxelGridSpec,
                                  cfg: TsdfIntegratorConfig,
                                  intr: PinholeIntrinsics,
                                  layers: vx.TsdfLayer, k: Tensor,
                                  depths: Tensor, colors: Optional[Tensor],
                                  T_sm_cams: Tensor,
                                  return_stats: bool = False):
    """Integrate a WINDOW of F frames into submap ``k`` of a stacked
    collection, IN PLACE, frame after frame (each frame: allocation pass,
    then one block-update launch over its touched blocks).
    colors: (F,3,H,W) | (F,H,W,3) | None.

    ``return_stats=True`` additionally returns ``(n_union, n_dropped,
    updated)``: the window's touched-slot union size (() int32), the count
    of blocks that lost their update (always 0 here: no working-set cap)
    and the (max_blocks,) bool bitmap of slots whose voxels were updated
    (feeds MapperState.mesh_dirty)."""
    mb = spec.max_blocks
    device = depths.device
    depths = depths.contiguous()
    if colors is not None:     # planar f32 once per window, as the kernel
        if color_layout(colors[0], intr.height, intr.width) == "interleaved":
            colors = colors.permute(0, 3, 1, 2)
        colors = colors.to(torch.float32).contiguous()
    touched = torch.zeros((mb + 1,), dtype=torch.bool, device=device)
    for f in range(depths.shape[0]):
        slots, mask = _alloc_pass(spec, cfg, intr, layers, k, depths[f],
                                  T_sm_cams[f])
        _mark_touched(touched, slots, mask)
        cuda_tsdf.update_blocks(
            spec, cfg, intr, layers, k, slots, mask, depths[f],
            None if colors is None else colors[f],
            geo.inverse(T_sm_cams[f]))
    if not return_stats:
        return layers
    touched = touched[:mb]
    return layers, (touched.sum(dtype=torch.int32),
                    torch.zeros((), dtype=torch.int32, device=device),
                    touched)


def integrate_frame(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                    intr: PinholeIntrinsics, layer: vx.TsdfLayer,
                    depth: Tensor, color: Optional[Tensor],
                    T_sm_cam: Tensor) -> vx.TsdfLayer:
    """Integrate one frame into a single layer, IN PLACE (an S = 1 view
    of the stacked path); returns ``layer``."""
    stacked = vx.TsdfLayer(**{f.name: getattr(layer, f.name)[None]
                              for f in dataclasses.fields(layer)})
    k = torch.zeros((), dtype=torch.int32, device=depth.device)
    integrate_frame_stacked_impl(spec, cfg, intr, stacked, k, depth, color,
                                 T_sm_cam)
    return layer
