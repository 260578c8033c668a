"""The ESDF build's Jacobi sweeps as CUDA kernels (``csrc/esdf_sweep.cu``)
over a layer's live blocks.

``ops.esdf.esdf_from_tsdf`` hands a CUDA layer to ``esdf_sweeps``, which
launches one init kernel (observed, the frozen band, the start field,
every dead row of the result, one neighbour-slot table a live block) and
one kernel a sweep over the live rows alone: 1 + n_iters launches a build,
``num_blocks`` read on the device, no host read. A CPU layer runs the plain
sweeps (``ops.esdf._esdf_sweeps``), the torch composition the JAX
package's XLA sweeps are written in. No TPU kernel is replaced. The
kernels repeat the plain version's f32 selects, mins, maxes, adds and
subtracts, so both give the same ``dist`` and ``observed`` bit for bit,
all max_blocks rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..core import voxel as vx
from ..utils.tensorops import check_operand as _check
from . import esdf

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# 1 + n_iters launches a call (the init kernel and one a sweep), counted
# under "esdf"
_BUILD = _build.EntryPoint("esdf", "cox_esdf_build", (
    [_P] * 10      # sdf, weight, index, coords, num_blocks, dist, observed,
                   # tmp, band, nbr
    + [_I] * 5     # B, v, gd, n_iters, full
    + [_F] * 3     # max_distance, truncation, min weight
    + [_P]))       # the host steps

MAX_VOXELS_PER_SIDE = 16    # v × v threads a CTA, (v + 2)³ f32 of box
NEIGHBOR_SLOTS = 27         # the table's row: every (dx, dy, dz) in {-1,0,1}³
# torch's `weight > 1e-6` compares in f32
MIN_WEIGHT = float(np.float32(1e-6))


def check_layer(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer, device) -> None:
    """Raise unless the kernels take ``tsdf``: 1 to 16 voxels a side, and
    f32 sdf and weight (B, v³), int32 block_index (g, g, g), block_coords
    (B, 3) and num_blocks (), contiguous, on ``device``."""
    v, g, B = spec.voxels_per_side, spec.grid_dim, tsdf.max_blocks
    if not 1 <= v <= MAX_VOXELS_PER_SIDE:
        raise ValueError(f"the ESDF kernels take 1 to {MAX_VOXELS_PER_SIDE} "
                         f"voxels a side, not {v}")
    f32, i32 = torch.float32, torch.int32
    _check("tsdf.sdf", tsdf.sdf, f32, (B, v ** 3), device)
    _check("tsdf.weight", tsdf.weight, f32, (B, v ** 3), device)
    _check("tsdf.block_index", tsdf.block_index, i32, (g, g, g), device)
    _check("tsdf.block_coords", tsdf.block_coords, i32, (B, 3), device)
    _check("tsdf.num_blocks", tsdf.num_blocks, i32, (), device)


def esdf_sweeps(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                cfg: esdf.EsdfConfig) -> esdf.EsdfLayer:
    """The ESDF of a CUDA layer through the kernels → an ``EsdfLayer``
    whose ``dist`` and ``observed`` equal ``ops.esdf._esdf_sweeps``' bit
    for bit. A layer off the card, or one ``check_layer`` refuses, raises
    before any launch."""
    device = tsdf.sdf.device
    if device.type != "cuda":
        raise ValueError(f"esdf_sweeps runs on cuda, not {device}")
    check_layer(spec, tsdf, device)
    v, g, B = spec.voxels_per_side, spec.grid_dim, tsdf.max_blocks
    f32, i32 = torch.float32, torch.int32
    n_iters = esdf.sweep_count(spec, cfg)
    # the kernels walk the offsets in _neighbor_offsets(True)'s order, the
    # faces alone when 6-connected, whose steps are all voxel_size
    steps = esdf.neighbor_steps(
        spec, esdf._neighbor_offsets(cfg.full_connectivity))
    dist = torch.empty((B, v ** 3), dtype=f32, device=device)
    observed = torch.empty((B, v ** 3), dtype=torch.bool, device=device)
    tmp = torch.empty_like(dist) if n_iters else None
    band = torch.empty((B, v * v), dtype=i32, device=device)
    nbr = torch.empty((B, NEIGHBOR_SLOTS), dtype=i32, device=device)

    _BUILD(
        device, tsdf.sdf.data_ptr(), tsdf.weight.data_ptr(),
        tsdf.block_index.data_ptr(), tsdf.block_coords.data_ptr(),
        tsdf.num_blocks.data_ptr(), dist.data_ptr(), observed.data_ptr(),
        None if tmp is None else tmp.data_ptr(), band.data_ptr(),
        nbr.data_ptr(), B, v, g, n_iters, int(cfg.full_connectivity),
        cfg.max_distance, spec.truncation, MIN_WEIGHT,
        steps.ctypes.data_as(ctypes.c_void_p), launches=1 + n_iters)
    return esdf.EsdfLayer(dist=dist, observed=observed,
                          block_index=tsdf.block_index,
                          block_coords=tsdf.block_coords,
                          num_blocks=tsdf.num_blocks)
