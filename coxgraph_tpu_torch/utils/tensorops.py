"""Device-side counterparts of JAX's ``.at[idx].set(val, mode="drop")``.

torch has no drop mode, and filtering lanes with a boolean mask would read
the mask back to the host. These helpers keep every write on the device:

* ``scatter_drop`` sends dropped lanes to a sentinel row allocated one past
  the end and sliced off (for small arrays: it copies ``dst``);
* ``put_row`` writes one row at a device index in place, writing the row's
  own value back when the index is out of range;
* ``put_rows`` writes the masked rows of a batch in place (a masked lane
  repeats a live lane's write, so no lane writes a row it does not own);
* ``where_fields`` selects between two dataclasses of tensors field by
  field (the counterpart of a ``lax.cond`` over a pytree).

``upload`` moves a host array to a device without a blocking copy;
``host`` brings a tensor (or any array-like) back as numpy.

``check_operand`` is the kernel wrappers' check of a tensor before its
pointer goes to CUDA.

``decimate`` and ``linspace`` are the JAX package's strided decimation
and ``jnp.linspace`` in the same f32 arithmetic.

``f32_reciprocal`` serves division by a constant: XLA rewrites ``x / c``
into ``x * (1/c)`` with the reciprocal rounded to f32, and torch does the
same on CUDA but divides exactly on the CPU. Writing the multiply out
makes the reference, the CPU and the GPU round alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def f32_reciprocal(c: float) -> float:
    """1/c rounded to f32 (exactly representable as the Python float)."""
    return float(np.float32(1.0) / np.float32(c))


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


def linspace(start: float, stop: float, num: int, device) -> Tensor:
    """jnp.linspace(start, stop, num) in its own f32 arithmetic
    (start·(1-s) + stop·s, s = iota·(1/div), with the stop appended), so
    the samples are the reference's to the bit."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32,
                        device=device) * f32_reciprocal(div)
    lo = torch.full((1,), start, dtype=torch.float32, device=device)
    hi = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([lo * (1 - step) + hi * step, hi])


def check_operand(name: str, t: Tensor, dtype, shape, device,
                  align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` whose data starts on an ``align``-byte boundary (what a
    kernel wrapper checks before it hands the pointer to CUDA)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def upload(x, device) -> Tensor:
    """A COPY of host array ``x`` as a tensor on ``device`` (``x`` may
    change at once), without a blocking copy: on the card through pinned
    staging and a non-blocking copy; the staging buffer lives until the
    copy has run."""
    if torch.device(device).type == "cuda":
        t = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
        return t.to(device, non_blocking=True)
    return torch.from_numpy(np.array(x)).to(device)


def host(x) -> np.ndarray:
    """A tensor (any device), a JAX array or an array-like → numpy."""
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scatter_drop(dst: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """Copy of ``dst`` with ``dst[idx] = val``; lanes with ``idx ==
    dst.shape[0]`` are dropped. In-range targets must be unique."""
    n = dst.shape[0]
    out = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    out[idx.long()] = val
    return out[:n]


def put_row(dst: Tensor, k: Tensor, val) -> None:
    """In place ``dst[k] = val`` for a 0-d device index ``k``; a no-op when
    ``k`` is out of range."""
    n = dst.shape[0]
    inside = k < n
    kc = torch.clamp(k, max=n - 1).long().reshape(1)
    cur = dst.index_select(0, kc)
    if isinstance(val, Tensor):
        val = val.to(dst.dtype).expand_as(cur[0])
    else:                       # a Python scalar: a fill, no host copy
        val = cur.new_full(cur.shape[1:], val)
    dst.index_copy_(0, kc, torch.where(inside, val[None], cur))


def put_rows(dst: Tensor, idx: Tensor, mask: Tensor, val: Tensor) -> None:
    """In place ``dst[idx[i]] = val[i]`` for every lane with ``mask[i]``;
    the other lanes write nothing. ``idx`` (K,) must be in range and
    unique over the masked lanes.

    A masked-off lane writes the first live lane's row and value again
    (the same bytes, so the duplicate is harmless); with no live lane,
    every lane writes ``dst[idx[0]]`` back to itself."""
    first = torch.argmax(mask.to(torch.int32)).reshape(1)
    fill = torch.where(mask[first].reshape((1,) * val.dim()),
                       val.index_select(0, first),
                       dst.index_select(0, idx[first].long()))
    m = mask.reshape((-1,) + (1,) * (val.dim() - 1))
    dst.index_copy_(0, torch.where(mask, idx, idx[first]).long(),
                    torch.where(m, val, fill).to(dst.dtype))


def where_fields(pred: Tensor, a, b):
    """Dataclass of tensors taking each field from ``a`` where ``pred``
    (a 0-d bool tensor) holds, else from ``b``."""
    return type(a)(**{f.name: torch.where(pred, getattr(a, f.name),
                                          getattr(b, f.name))
                      for f in dataclasses.fields(a)})
