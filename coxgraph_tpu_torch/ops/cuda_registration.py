"""The Gauss-Newton terms of dense registration pairs as one CUDA kernel
(``csrc/registration_terms.cu``).

``pair_terms`` dispatches by the device: CUDA tensors launch the kernel,
one CTA a pair and one launch a call, with no host read; CPU tensors run
the plain version, ``ops.registration.pair_terms`` over the table's
lookup (``registration.stacked_slots``), the torch composition the JAX
package's XLA terms are written in. No TPU kernel is replaced. The kernel
repeats the plain arithmetic point by point, so validity, residuals and
Jacobians agree bit for bit, and H, b and cost differ from the plain sums
only by their order; it uses no atomics, so its outputs repeat bit for bit.

Both callers share it: the phase-2 solve hands it the stacked field of S
submaps (rows j·R + [0, R) for table row j = ``pair_j[p]``), and
``registration.registration_normal_eq`` one layer as the S = 1 table.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from ..core import voxel as vx
from ..solver.pose_graph import renormalized
from ..utils.tensorops import check_operand as _check
from ..utils.tensorops import f32_reciprocal
from . import registration as reg    # imports this module back

Tensor = torch.Tensor

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one launch a call, counted under "reg"
_TERMS = _build.EntryPoint("reg", "cox_registration_terms", (
    [_P] * 13      # sdf, weight, table, pair_j, pts, sdf_A, mask_A, T_A,
                   # T_B, H, b, cost, n_valid
    + [_I] * 6     # P, Q, S, R, v, gd
    + [_F] * 3))   # 1/voxel_size, truncation, huber_delta


def check_operands(spec: vx.VoxelGridSpec, sdf: Tensor, weight: Tensor,
                   block_index: Tensor, pair_j: Optional[Tensor],
                   pts_A: Tensor, sdf_A: Tensor, mask_A: Tensor,
                   T_O_A: Tensor, T_O_B: Tensor, device) -> tuple:
    """Raise unless the kernel takes these operands: f32 sdf and weight
    (S·R, v³), an int32 table (S, G³), int64 pair_j of the pairs' shape
    (or None, every pair on row 0), f32 points (..., Q, 3), f32 sdf_A and
    bool mask_A (..., Q), f32 poses (..., 7), all contiguous on ``device``
    → (P, Q, S, R), P the product of the leading axes."""
    v3, g3 = spec.voxels_per_side ** 3, spec.grid_dim ** 3
    if block_index.dim() != 2 or block_index.shape[0] < 1:
        raise ValueError(f"block_index has shape {tuple(block_index.shape)},"
                         f" expected (S, {g3})")
    S = block_index.shape[0]
    if sdf.dim() != 2 or sdf.shape[0] % S or not sdf.shape[0]:
        raise ValueError(f"sdf has shape {tuple(sdf.shape)}, expected "
                         f"(S·R, {v3}) with S = {S}")
    R = sdf.shape[0] // S
    if pts_A.dim() < 2:
        raise ValueError(f"pts_A has shape {tuple(pts_A.shape)}, expected "
                         f"(..., Q, 3)")
    lead, Q = tuple(pts_A.shape[:-2]), pts_A.shape[-2]
    f32 = torch.float32
    _check("sdf", sdf, f32, (S * R, v3), device)
    _check("weight", weight, f32, (S * R, v3), device)
    _check("block_index", block_index, torch.int32, (S, g3), device)
    if pair_j is not None:
        _check("pair_j", pair_j, torch.int64, lead, device)
    _check("pts_A", pts_A, f32, lead + (Q, 3), device)
    _check("sdf_A", sdf_A, f32, lead + (Q,), device)
    _check("mask_A", mask_A, torch.bool, lead + (Q,), device)
    _check("T_O_A", T_O_A, f32, lead + (7,), device)
    _check("T_O_B", T_O_B, f32, lead + (7,), device)
    return math.prod(lead), Q, S, R


def pair_terms(spec: vx.VoxelGridSpec, sdf: Tensor, weight: Tensor,
               block_index: Tensor, pair_j: Optional[Tensor],
               pts_A: Tensor, sdf_A: Tensor, mask_A: Tensor,
               T_O_A: Tensor, T_O_B: Tensor, huber_delta: float,
               cost_only: bool = False):
    """Huber-weighted GN terms of registration pairs, batched over any
    leading axes: the points of pair p sample the field of S submaps,
    sdf / weight (S·R, v³), at the block rows ``block_index[pair_j[p]]``
    ((S, G³), rows in [0, R) or -1; ``pair_j`` None: row 0) offset by
    ``pair_j[p]``·R. → ``registration.pair_terms``' (H (..., 12, 12),
    b (..., 12), cost (...), n_valid (...) int32); with ``cost_only`` H and
    b are None. CUDA operands the kernel does not take raise before any
    launch."""
    device = sdf.device
    if device.type != "cuda":
        R = sdf.shape[0] // block_index.shape[0]
        H, b, cost, n = reg.pair_terms(
            spec, sdf, weight, reg.stacked_slots(spec, block_index, pair_j,
                                                 R),
            pts_A, sdf_A, mask_A, T_O_A, T_O_B, huber_delta)
        return (None, None, cost, n) if cost_only else (H, b, cost, n)
    P, Q, S, R = check_operands(spec, sdf, weight, block_index, pair_j,
                                pts_A, sdf_A, mask_A, T_O_A, T_O_B, device)
    lead = tuple(pts_A.shape[:-2])
    f32 = torch.float32
    H = None if cost_only else torch.empty(lead + (12, 12), dtype=f32,
                                           device=device)
    b = None if cost_only else torch.empty(lead + (12,), dtype=f32,
                                           device=device)
    cost = torch.empty(lead, dtype=f32, device=device)
    n = torch.empty(lead, dtype=torch.int32, device=device)
    # the poses the plain version evaluates at, computed as it computes them
    TA, TB = renormalized(T_O_A), renormalized(T_O_B)
    _TERMS(
        device, sdf.data_ptr(), weight.data_ptr(), block_index.data_ptr(),
        None if pair_j is None else pair_j.data_ptr(), pts_A.data_ptr(),
        sdf_A.data_ptr(), mask_A.data_ptr(), TA.data_ptr(), TB.data_ptr(),
        None if H is None else H.data_ptr(),
        None if b is None else b.data_ptr(), cost.data_ptr(), n.data_ptr(),
        P, Q, S, R, spec.voxels_per_side, spec.grid_dim,
        f32_reciprocal(spec.voxel_size), spec.truncation, huber_delta)
    return H, b, cost, n
