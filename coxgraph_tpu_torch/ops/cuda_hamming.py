"""Brute-force Hamming matching of packed BRIEF-256 descriptors — the CUDA
kernel that replaces the TPU kernel
``coxgraph_tpu/ops/pallas_kernels.py::_match_kernel``, and its plain torch
version.

Descriptors are ``(..., 8)`` int32 tensors holding the bit patterns of the
JAX package's uint32 words (torch's uint32 lacks shifts and sums on most
backends). Two entry points:

* ``hamming_match_topk(da, db)`` — K2's own function: per row of ``da``
  the best distance ``d1``, the lowest column ``i1`` reaching it, and
  ``d2``, the best distance with column ``i1`` set to ``1 << 15``.
* ``match_topk(a, a_valid, b, b_valid, big, excl)`` — the batched, masked
  form behind ``features.match_descriptors``: queries ``a (B, Ka, 8)``
  against database rows ``b (B or 1, cap, Kb, 8)``; a distance with an
  invalid side is ``big``; ``d2`` excludes ``i1`` by setting it to
  ``excl``. Returns ``d1, i1, d2 (B, cap, Ka)`` and ``best_a (B, cap,
  Kb)``, the lowest row reaching each column's minimum.

Both dispatch by the tensors' device: CUDA tensors launch the kernel in
``csrc/hamming_match.cu`` (or raise), CPU tensors run the plain version
(``*_reference``: the SWAR popcount over the full distance tensor, then
``min``/``argmin``, which return the first index among ties, as JAX's do).
There is no fallback from the one to the other. All outputs are integers,
and kernel and plain version agree exactly.

The kernel runs on Hopper's int8 tensor cores: it expands each bit of the
packed words to a ±1 int8 (zero for an invalid descriptor), so a distance
is ``(256 − dot) / 2`` of a 256-deep s8 product (``wgmma`` m64n32k32),
and reduces in registers on int32 keys ``(d << 16) | index`` — one
multiply-add on the dot product each, exact because ``d < 2^15`` and
``index < 2^16`` — hence the limits ``Ka < 65536``, ``Kb ≤ 1024`` and
``big < 2^15`` checked here. The source's header has the tiling and what
bounds it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..utils.tensorops import check_operand

Tensor = torch.Tensor

N_WORDS = 8
# K2's second-best sentinel (pallas_kernels.py:57)
TOPK_SENTINEL = 1 << 15

# one launch a call, counted under "k2"
_TOPK = _build.EntryPoint("k2", "cox_hamming_topk", (
    [ctypes.c_void_p] * 8     # a, a_valid, b, b_valid, d1, i1, d2, best_a
    + [ctypes.c_int] * 7))    # n_q, cap, ka, kb, b_batched, big, excl


def popcount32(x: Tensor) -> Tensor:
    """Bits set in each int32 word (SWAR). Exact on int32 bit patterns:
    every mask clears the bits an arithmetic shift fills with the sign,
    and the byte sums are taken by shifts, so nothing overflows."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def distances_reference(a: Tensor, b: Tensor) -> Tensor:
    """(..., Ka, 8) × (..., Kb, 8) int32 → (..., Ka, Kb) int32 Hamming
    distances, one word at a time (a (…, Ka, Kb) transient per word)."""
    d = None
    for w in range(N_WORDS):
        x = popcount32(a[..., :, None, w] ^ b[..., None, :, w])
        d = x if d is None else d.add_(x)
    return d


def _top2(D: Tensor, excl: int) -> Tuple[Tensor, Tensor, Tensor]:
    d1, i1 = torch.min(D, dim=-1)
    d2 = torch.min(D.scatter(-1, i1[..., None], excl), dim=-1).values
    return d1, i1.to(torch.int32), d2


def hamming_match_topk_reference(da: Tensor, db: Tensor):
    """Plain version of ``hamming_match_topk``
    (``pallas_kernels.hamming_match_topk_reference``)."""
    return _top2(distances_reference(da, db), TOPK_SENTINEL)


def match_topk_reference(a: Tensor, a_valid: Tensor, b: Tensor,
                         b_valid: Tensor, big: int, excl: int):
    """Plain version of ``match_topk`` (``features.match_descriptors``'s
    distance, top-2 and column argmin, ``features.py:223-231``)."""
    D = distances_reference(a[:, None], b)              # (B, cap, Ka, Kb)
    ok = a_valid[:, None, :, None] & b_valid[:, :, None, :]
    D = torch.where(ok, D, big)
    d1, i1, d2 = _top2(D, excl)
    best_a = torch.argmin(D, dim=-2).to(torch.int32)
    return d1, i1, d2, best_a


def _launch(a: Tensor, a_valid: Optional[Tensor], b: Tensor,
            b_valid: Optional[Tensor], big: int, excl: int,
            want_cols: bool):
    """Check the CUDA operands and launch the kernel once → (d1, i1, d2,
    best_a or None)."""
    device = a.device
    if device.type != "cuda":
        raise ValueError(f"the Hamming kernel runs on cuda, not {device}")
    nq, ka = a.shape[0], a.shape[1]
    if b.dim() != 4 or b.shape[0] not in (1, nq):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected "
                         f"({nq} or 1, cap, Kb, {N_WORDS})")
    cap, kb = b.shape[1], b.shape[2]
    i32 = torch.int32
    # the kernel reads descriptor rows as two 16-byte uint4 words
    check_operand("a", a, i32, (nq, ka, N_WORDS), device, align=16)
    check_operand("b", b, i32, (b.shape[0], cap, kb, N_WORDS), device,
                  align=16)
    if a_valid is not None:
        check_operand("a_valid", a_valid, torch.bool, (nq, ka), device)
    if b_valid is not None:
        check_operand("b_valid", b_valid, torch.bool, (b.shape[0], cap, kb),
                      device)
    if not (0 <= big < 1 << 15 and 0 <= excl < 1 << 31):
        raise ValueError("big must lie in [0, 2^15) and excl in [0, 2^31)")
    if ka >= 1 << 16 or kb > 1024:
        raise ValueError(f"Ka < 65536 and Kb <= 1024 only (got {ka}, {kb})")
    d1 = torch.empty((nq, cap, ka), dtype=i32, device=device)
    i1 = torch.empty_like(d1)
    d2 = torch.empty_like(d1)
    best_a = (torch.empty((nq, cap, kb), dtype=i32, device=device)
              if want_cols else None)


    def ptr(t):
        return None if t is None else t.data_ptr()

    _TOPK(device, a.data_ptr(), ptr(a_valid), b.data_ptr(), ptr(b_valid),
          d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), ptr(best_a),
          nq, cap, ka, kb, int(b.shape[0] != 1), big, excl)
    return d1, i1, d2, best_a


def hamming_match_topk(da: Tensor, db: Tensor):
    """(Ka, 8) × (Kb, 8) int32 descriptors → (d1, i1, d2), each (Ka,)
    int32: best and second-best distance and the best index in ``db`` for
    every row of ``da`` (``pallas_kernels.hamming_match_topk``; any Ka).

    CUDA tensors launch the kernel or raise; CPU tensors run
    ``hamming_match_topk_reference``."""
    if da.device.type == "cpu":
        return hamming_match_topk_reference(da, db)
    d1, i1, d2, _ = _launch(da[None], None, db[None, None], None, 0,
                            TOPK_SENTINEL, want_cols=False)
    return d1[0, 0], i1[0, 0], d2[0, 0]


def match_topk(a: Tensor, a_valid: Tensor, b: Tensor, b_valid: Tensor,
               big: int, excl: int):
    """Batched masked matcher → (d1, i1, d2 (B, cap, Ka), best_a (B, cap,
    Kb)), all int32.

    a (B, Ka, 8) int32, a_valid (B, Ka) bool; b (B or 1, cap, Kb, 8)
    int32, b_valid (B or 1, cap, Kb) bool (a leading 1 is shared by every
    query). CUDA tensors launch the kernel (one launch) or
    raise; CPU tensors run ``match_topk_reference``."""
    if a.device.type == "cpu":
        return match_topk_reference(a, a_valid, b, b_valid, big, excl)
    return _launch(a, a_valid, b, b_valid, big, excl, want_cols=True)
