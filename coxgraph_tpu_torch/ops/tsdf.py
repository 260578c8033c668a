"""Projective TSDF integration of RGB-D frames — port of
``coxgraph_tpu.ops.tsdf``.

Each frame is integrated in two passes:

  1. **Allocation** — backproject a strided pixel grid at a few depths
     spanning the truncation band, take the smallest touched block cells,
     allocate new blocks and compact the touched pool slots
     (``ops.cuda_alloc.alloc_pass``: two CUDA kernels on the GPU, the
     plain torch pass on the CPU; integers bit-identical to the JAX
     package).
  2. **Update** — project the voxel centres of every touched block into
     the frame, gather depth and colour and apply the weighted
     running-average TSDF update (``ops.cuda_tsdf.update_blocks``: the CUDA
     kernel on the GPU, its plain torch twin on the CPU).

A window of frames runs the frames in sequence, with the semantics of the
reference's XLA path: no working-set cap, so every touched block of every
frame is updated (the JAX package's ``n_dropped`` is 0).

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

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..utils.tensorops import scatter_drop
from . import cuda_alloc, cuda_tsdf

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TsdfIntegratorConfig:
    """Static integrator parameters: the JAX package's fields and defaults
    that the card reads. ``utils.interop.config_from`` copies a JAX config
    into these fields and drops its four that configure the TPU's Pallas
    path and working set: here one kernel launch covers all touched
    blocks, and a window has no union cap."""

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


def integrate_window_stacked_impl(spec: vx.VoxelGridSpec,
                                  cfg: TsdfIntegratorConfig,
                                  intr: PinholeIntrinsics,
                                  layers: vx.TsdfLayer, k: Tensor,
                                  depths: Tensor, colors: Optional[Tensor],
                                  T_sm_cams: Tensor) -> Tensor:
    """Integrate a WINDOW of F frames into submap ``k`` (0-d int32 device
    tensor) of a stacked collection, IN PLACE, frame after frame (each
    frame: allocation pass, then one block-update launch over its touched
    blocks) → the (max_blocks,) bool bitmap of slots whose voxels were
    updated (feeds MapperState.mesh_dirty; its count is the window's
    touched-slot union, the JAX package's ``n_union``).

    depths: (F,H,W) z-depth (0 = invalid); colors: (F,3,H,W) | (F,H,W,3)
    in [0,1], or None; T_sm_cams: (F,7) camera poses in the submap
    frame."""
    mb = spec.max_blocks
    device = depths.device
    depths = depths.contiguous()
    if colors is not None:     # planar f32 once per window, as the kernel
        if color_layout(colors[0], intr.height, intr.width) == "interleaved":
            colors = colors.permute(0, 3, 1, 2)
        colors = colors.to(torch.float32).contiguous()
    T_sm_cams = T_sm_cams.contiguous()
    touched = torch.zeros((mb + 1,), dtype=torch.bool, device=device)
    marks = (cuda_alloc.new_marks(spec, device)
             if device.type == "cuda" else None)
    for f in range(depths.shape[0]):
        with runtime.span("tsdf.alloc"):
            slots, mask = cuda_alloc.alloc_pass(spec, cfg, intr, layers, k,
                                                depths[f], T_sm_cams[f],
                                                touched, marks)
        with runtime.span("tsdf.update_blocks"):
            cuda_tsdf.update_blocks(
                spec, cfg, intr, layers, k, slots, mask, depths[f],
                None if colors is None else colors[f],
                geo.inverse(T_sm_cams[f]))
    return touched[:mb]


def integrate_frame(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                    intr: PinholeIntrinsics, layer: vx.TsdfLayer,
                    depth: Tensor, color: Optional[Tensor],
                    T_sm_cam: Tensor) -> vx.TsdfLayer:
    """Integrate one frame into a single layer, IN PLACE (an S = 1 view
    of the stacked path); returns ``layer``."""
    stacked = vx.TsdfLayer(**{f.name: getattr(layer, f.name)[None]
                              for f in dataclasses.fields(layer)})
    k = torch.zeros((), dtype=torch.int32, device=depth.device)
    integrate_window_stacked_impl(spec, cfg, intr, stacked, k, depth[None],
                                  None if color is None else color[None],
                                  T_sm_cam[None])
    return layer
