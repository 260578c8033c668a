"""The arithmetic of K2's tensor-core kernel (csrc/hamming_match.cu),
emulated in torch on the CPU and held to the port's plain version, to the
Pallas kernel in interpret mode and to its jnp reference.

The emulation follows the kernel step by step: bits unpacked to ±1 int8
(zero for an invalid descriptor), integer dot products, row keys
``(d << 16) | c`` and column keys ``(d << 16) | i`` as one multiply-add
on the dot product with the masks in per-column and per-row constants,
the row top-2 updated two columns at a time by each of the four lanes
that share a row and then merged across them, the column-key minimum,
and the closed forms of invalid rows and columns. It is test code only:
the package has one path per device. Every comparison is exact
(integers)."""

import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.ops import pallas_kernels as pk
from coxgraph_tpu_torch.ops import cuda_hamming
from test_torch_cuda import edge_cases

BIG = 10_000
INT_MAX = 2 ** 31 - 1
EDGES = [(ka, kb) for ka in (100, 200) for kb in (1, 7, 200)]


def _pm1(words, valid):
    """(..., 8) int32 words → (..., 256) int64 of ±1 (+1 for a set bit),
    all zero where ``valid`` is False."""
    bits = (words[..., :, None] >> torch.arange(32)) & 1
    x = (2 * bits - 1).reshape(*words.shape[:-1], 256).long()
    return x * valid[..., None].long()


def _top2_update(m1, m2, k0, k1):
    """The kernel's two-keys-at-a-time top-2 (unique keys)."""
    lo, hi = torch.minimum(k0, k1), torch.maximum(k0, k1)
    m2 = torch.minimum(torch.minimum(m2, torch.maximum(m1, lo)), hi)
    return torch.minimum(m1, lo), m2


def _top2_merge(m1, m2, o1, o2):
    """Merge of two lanes' top-2 over disjoint columns."""
    m2 = torch.minimum(torch.minimum(torch.maximum(m1, o1), m2), o2)
    return torch.minimum(m1, o1), m2


def emulate(a, a_valid, b, b_valid, big, excl, want_cols=True):
    """K2's arithmetic on (B, Ka, 8) × (B or 1, cap, Kb, 8) → (d1, i1, d2
    (B, cap, Ka), best_a (B, cap, Kb) or None), all int32."""
    ka, kb = a.shape[1], b.shape[2]
    av = a_valid[:, None, :]                              # (B, 1, Ka)
    bv = b_valid                                          # (B|1, cap, Kb)
    dot = torch.einsum("qik,qjck->qjic", _pm1(a, a_valid), _pm1(b, bv))
    # padded to whole 32-column groups (one wgmma's width), as the kernel's
    # shared memory is: zero rows whose row-key constant is INT_MAX
    kb8 = -(-kb // 32) * 32
    dot = torch.nn.functional.pad(dot, (0, kb8 - kb))
    cols = torch.arange(kb8)
    col_k = torch.where(bv, (256 << 15) | cols[:kb], (big << 16) | cols[:kb])
    col_k = torch.nn.functional.pad(col_k.long(), (0, kb8 - kb),
                                    value=INT_MAX)[:, :, None, :]
    row_k = torch.where(av, (256 << 15) | torch.arange(ka),
                        (big << 16) | torch.arange(ka)).long()[..., None]
    keys = dot * -32768 + col_k                            # row keys
    assert int(keys.min()) >= 0 and int(keys.max()) <= INT_MAX

    # lane t of a quad takes columns 8 n + 2 t and 8 n + 2 t + 1
    m1 = torch.full((4,) + keys.shape[:-1], INT_MAX, dtype=torch.long)
    m2 = m1.clone()
    for n in range(kb8 // 8):
        for t in range(4):
            c = 8 * n + 2 * t
            m1[t], m2[t] = _top2_update(m1[t], m2[t], keys[..., c],
                                        keys[..., c + 1])
    for off in (1, 2):                                     # xor shuffles
        o1, o2 = m1[[t ^ off for t in range(4)]], m2[[t ^ off for t in
                                                       range(4)]]
        m1, m2 = _top2_merge(m1, m2, o1, o2)
    m1, m2 = m1[0], m2[0]
    ok = av.expand(m1.shape)
    d1 = torch.where(ok, m1 >> 16, big)
    i1 = torch.where(ok, m1 & 0xFFFF, 0)
    d2 = torch.where(ok, m2 >> 16, big)
    d2 = torch.minimum(d2, torch.tensor(excl)) if kb > 1 else \
        torch.full_like(d2, excl)
    best_a = None
    if want_cols:
        ckeys = dot[..., :kb] * -32768 + row_k             # column keys
        best = ckeys.min(dim=-2).values & 0xFFFF
        best_a = torch.where(bv, best, 0).expand(
            a.shape[0], *best.shape[1:]).int()
    return d1.int(), i1.int(), d2.int(), best_a


def _words(rng, *shape):
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (*shape, 8),
                                         dtype=np.int64).astype(np.int32))


def _edge_inputs(seed, nq, cap, ka, kb, batched):
    """Seeded random words, ~90% valid, edited into the kernel's masking
    and tie cases by test_torch_cuda.edge_cases."""
    rng = np.random.default_rng(seed)
    a = _words(rng, nq, ka)
    b = _words(rng, nq if batched else 1, cap, kb)
    av = torch.from_numpy(rng.random((nq, ka)) < 0.9)
    bv = torch.from_numpy(rng.random(tuple(b.shape[:-1])) < 0.9)
    edge_cases(a, av, b, bv)
    return a, av, b, bv


def _assert_equal(got, want, names=("d1", "i1", "d2", "best_a")):
    for g, w, name in zip(got, want, names):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == np.int32 and w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("ka,kb", EDGES + [(384, 384), (64, 512)])
def test_emulation_matches_plain_version(ka, kb, batched):
    """Masked, batched form at the edge shapes (Ka not a multiple of the
    kernel's row tiles, Kb of 1, 7, 200), at the endurance keypoint count
    and at Kb = 512, with b shared and per query."""
    nq, cap = (3, 4) if not batched else (3, 2)
    args = _edge_inputs(ka * 7 + kb + batched, nq, cap, ka, kb, batched)
    _assert_equal(emulate(*args, BIG, BIG),
                  cuda_hamming.match_topk_reference(*args, BIG, BIG))


@pytest.mark.parametrize("ka,kb", [(128, 96), (128, 7), (256, 1),
                                   (128, 200)])
def test_emulation_matches_pallas_kernel(ka, kb):
    """hamming_match_topk's form (no masks, sentinel 1 << 15) vs the
    Pallas kernel in interpret mode (Ka a multiple of its 128-row tile)
    and its jnp reference, with tied columns."""
    rng = np.random.default_rng(ka + kb)
    da = rng.integers(0, 2 ** 32, (ka, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2 ** 32, (kb, 8), dtype=np.uint64).astype(np.uint32)
    db[: min(ka, kb) // 2] = da[: min(ka, kb) // 2]
    db[-1] = db[0]
    ta = torch.from_numpy(da.view(np.int32).copy())
    tb = torch.from_numpy(db.view(np.int32).copy())
    got = emulate(ta[None], torch.ones(1, ka, dtype=torch.bool),
                  tb[None, None], torch.ones(1, 1, kb, dtype=torch.bool),
                  0, cuda_hamming.TOPK_SENTINEL, want_cols=False)[:3]
    got = [x[0, 0] for x in got]
    pal = pk.hamming_match_topk(jnp.asarray(da), jnp.asarray(db),
                                interpret=True)
    ref = pk.hamming_match_topk_reference(jnp.asarray(da), jnp.asarray(db))
    _assert_equal(got, pal)
    _assert_equal(got, ref)


@pytest.mark.parametrize("ka,kb", EDGES)
def test_emulation_matches_jnp_reference(ka, kb):
    """hamming_match_topk's form at any Ka vs the jnp reference."""
    rng = np.random.default_rng(3 * ka + kb)
    da = rng.integers(0, 2 ** 32, (ka, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2 ** 32, (kb, 8), dtype=np.uint64).astype(np.uint32)
    db[: min(ka, kb) // 2] = da[: min(ka, kb) // 2]
    da[-1] = da[0]
    ta = torch.from_numpy(da.view(np.int32).copy())
    tb = torch.from_numpy(db.view(np.int32).copy())
    got = emulate(ta[None], torch.ones(1, ka, dtype=torch.bool),
                  tb[None, None], torch.ones(1, 1, kb, dtype=torch.bool),
                  0, cuda_hamming.TOPK_SENTINEL, want_cols=False)[:3]
    ref = pk.hamming_match_topk_reference(jnp.asarray(da), jnp.asarray(db))
    _assert_equal([x[0, 0] for x in got], ref)
    _assert_equal([x[0, 0] for x in got],
                  cuda_hamming.hamming_match_topk_reference(ta, tb))


def test_closed_forms_of_invalid_rows_and_columns():
    """A wholly invalid query row gives d1 = big, i1 = 0, d2 = min(excl,
    big) (excl when Kb = 1); a wholly invalid column gives best_a = 0;
    with every key derived from the constants alone."""
    for kb, excl in ((7, BIG), (7, 50), (1, BIG)):
        a, av, b, bv = _edge_inputs(kb + excl, 2, 3, 40, kb, False)
        av[0] = False
        bv[0, 1] = False
        got = emulate(a, av, b, bv, BIG, excl)
        want = cuda_hamming.match_topk_reference(a, av, b, bv, BIG, excl)
        _assert_equal(got, want)
        assert (got[0][0] == BIG).all() and (got[1][0] == 0).all()
        assert (got[2][0] == (min(excl, BIG) if kb > 1 else excl)).all()
        assert (got[3][:, 1] == 0).all()


@pytest.mark.parametrize("ka,kb", [(100, 7), (200, 200)])
def test_emulation_with_a_small_big(ka, kb):
    """big below the typical distance (100 < ~128): masked entries compete
    with real ones, so the index half of every masked key and the tie
    order among masked columns and rows decide the outputs."""
    args = _edge_inputs(ka + kb, 3, 4, ka, kb, False)
    _assert_equal(emulate(*args, 100, 100),
                  cuda_hamming.match_topk_reference(*args, 100, 100))


def test_variant_edits_apply_to_the_kernel_source():
    """tools/time_k2_variants.py times K2 against edited copies of its
    source: each of its edits must still match the source exactly once
    and change it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = runpy.run_path(os.path.join(repo, "tools", "time_k2_variants.py"),
                          run_name="not_main")
    with open(os.path.join(repo, "coxgraph_tpu_torch", "csrc",
                           "hamming_match.cu")) as f:
        src = f.read()
    for name, (_, edits) in tool["VARIANTS"].items():
        assert tool["_edited"](src, edits) != src, name
