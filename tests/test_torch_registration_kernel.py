"""The registration kernel's wrapper (``ops.cuda_registration``) on the CPU.

Its kernel (``csrc/registration_terms.cu``) runs only on a card, where
tests/test_torch_cuda.py holds it to the plain composition. Here: CPU
tensors take the plain composition, which for one layer is the lookup
through ``vx.lookup_block`` bit for bit and for the stacked field of the
phase-2 solve each pair's own layer; the cost-only form gives the full
form's cost and count; the operand check refuses what the kernel cannot
take before any launch; the callers make the calls the launch count
predicts (2·iterations + 1 a two-phase solve, iterations + 2 a
``register_pair``); ``runtime.snapshot()`` counts the launches."""

import dataclasses

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.eval import benchmarks as bm
from coxgraph_tpu_torch.ops import cuda_registration as creg
from coxgraph_tpu_torch.ops import registration as reg
from coxgraph_tpu_torch.server import global_opt as go

CPU = torch.device("cpu")
N = 6          # submaps of the small solve problem
R = 6          # stacked rows a submap: each submap's 16 blocks lose 6-15
Q = 256


@pytest.fixture(scope="module")
def problem():
    """The small solve problem (wavy floor, 0.1 m voxels, 8³ blocks, 64
    slots), its overlapping pairs at the drifted start, their point
    caches, and the stacked field at R = 6 rows a submap."""
    init, cons, layers, spec, rcfg, scfg, fixed = \
        bm.solve_benchmark_problem(N, device=CPU)
    pairs = go.find_overlapping_pairs(spec, layers, init)
    rp = go.make_registration_pairs(spec, layers, pairs, rcfg)
    ij = torch.tensor(pairs, dtype=torch.int64).T.contiguous()
    sdf, w, bi = go._stack_fields(layers, R)
    # poses off the lattice: the drifted chain, nudged per submap
    g = torch.Generator().manual_seed(5)
    poses = geo.compose(init, geo.se3_exp(0.02 * torch.randn(
        N, 6, generator=g)))
    return dict(spec=spec, layers=layers, poses=poses, pairs=pairs,
                pair_i=ij[0].contiguous(), pair_j=ij[1].contiguous(),
                pts=torch.stack([p.pts_i for p in rp]),
                sdfA=torch.stack([p.sdf_i for p in rp]),
                maskA=torch.stack([p.mask_i for p in rp]),
                sdf=sdf, w=w, bi=bi, delta=rcfg.huber_delta)


def _stacked_args(P):
    return (P["sdf"], P["w"], P["bi"], P["pair_j"], P["pts"], P["sdfA"],
            P["maskA"], P["poses"][P["pair_i"]], P["poses"][P["pair_j"]])


def test_one_layer_is_the_lookup_block_composition(problem):
    """``registration_normal_eq`` (the S = 1 table, no pair_j) on the CPU
    equals the plain terms over ``vx.lookup_block``, as before the kernel,
    bit for bit."""
    P = problem
    spec, layer = P["spec"], P["layers"][1]
    args = (P["pts"][0], P["sdfA"][0], P["maskA"][0], P["poses"][0],
            P["poses"][1])
    got = reg.registration_normal_eq(spec, layer, *args, P["delta"])
    want = reg.pair_terms(spec, layer.sdf, layer.weight,
                          lambda b: vx.lookup_block(spec, layer, b), *args,
                          P["delta"])
    assert int(want[3]) > 50
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_stacked_pairs_are_their_own_layers(problem):
    """The stacked field's pair p is pair p alone on submap pair_j[p]'s
    layer with its rows from R on dropped: n_valid exact, H and b within
    1e-5 of their max |·|, cost within 1e-5 (the batched and the single
    einsum may sum in another order)."""
    P = problem
    spec = P["spec"]
    H, b, cost, n = creg.pair_terms(spec, *_stacked_args(P), P["delta"])
    assert H.shape == (len(P["pairs"]), 12, 12) and n.dtype == torch.int32
    assert int(n.max()) > 50
    for p, (i, j) in enumerate(P["pairs"]):
        layer = P["layers"][j]
        cut = dataclasses.replace(layer, block_index=torch.where(
            layer.block_index < R, layer.block_index, -1))
        Hp, bp, cp, np_ = reg.registration_normal_eq(
            spec, cut, P["pts"][p], P["sdfA"][p], P["maskA"][p],
            P["poses"][i], P["poses"][j], P["delta"])
        assert int(n[p]) == int(np_), p
        assert float((H[p] - Hp).abs().max()) <= 1e-5 * float(
            Hp.abs().max())
        assert float((b[p] - bp).abs().max()) <= 1e-5 * float(
            bp.abs().max())
        assert abs(float(cost[p]) - float(cp)) <= 1e-5 * float(cp)
    # the cut drops samples: some point reads a row at or above R
    full = [int(reg.registration_normal_eq(
        spec, P["layers"][j], P["pts"][p], P["sdfA"][p], P["maskA"][p],
        P["poses"][i], P["poses"][j])[3]) for p, (i, j) in
        enumerate(P["pairs"])]
    assert sum(full) > int(n.sum())


def test_cost_only_is_the_full_cost(problem):
    P = problem
    full = creg.pair_terms(P["spec"], *_stacked_args(P), P["delta"])
    part = creg.pair_terms(P["spec"], *_stacked_args(P), P["delta"],
                           cost_only=True)
    assert part[0] is None and part[1] is None
    assert torch.equal(part[2], full[2]) and torch.equal(part[3], full[3])


CASES = {
    "sdf_dtype": lambda a: a.update(sdf=a["sdf"].double()),
    "weight_rows": lambda a: a.update(weight=a["weight"][:-1]),
    "table_dtype": lambda a: a.update(block_index=a["block_index"].long()),
    "rows_not_whole": lambda a: a.update(sdf=a["sdf"][:-1],
                                         weight=a["weight"][:-1]),
    "table_width": lambda a: a.update(
        block_index=a["block_index"][:, :-1].contiguous()),
    "pair_j_dtype": lambda a: a.update(pair_j=a["pair_j"].int()),
    "pair_j_count": lambda a: a.update(pair_j=a["pair_j"][:-1]),
    "pts_shape": lambda a: a.update(pts_A=a["pts_A"][..., :2].contiguous()),
    "sdf_A_shape": lambda a: a.update(sdf_A=a["sdf_A"][:, :-1]
                                      .contiguous()),
    "mask_dtype": lambda a: a.update(mask_A=a["mask_A"].to(torch.uint8)),
    "pose_width": lambda a: a.update(T_O_B=a["T_O_B"][:, :6].contiguous()),
    "strided_pts": lambda a: a.update(
        pts_A=a["pts_A"].transpose(0, 1).contiguous().transpose(0, 1)),
    "other_device": lambda a: a.update(device=torch.device("cuda", 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_operands_refuses_what_the_kernel_cannot_take(problem, case):
    """Each wrong dtype, shape, layout or device raises; the stacked
    operands and the one-layer form pass."""
    P = problem
    spec = P["spec"]
    names = ("sdf", "weight", "block_index", "pair_j", "pts_A", "sdf_A",
             "mask_A", "T_O_A", "T_O_B")
    args = dict(zip(names, _stacked_args(P)), device=CPU)
    assert creg.check_operands(spec, **args) == (len(P["pairs"]), Q, N, R)
    layer = P["layers"][0]
    assert creg.check_operands(
        spec, layer.sdf, layer.weight, layer.block_index.reshape(1, -1),
        None, P["pts"][0], P["sdfA"][0], P["maskA"][0], P["poses"][0],
        P["poses"][1], CPU) == (1, Q, 1, spec.max_blocks)
    before = runtime.launches("reg")
    CASES[case](args)
    with pytest.raises((ValueError, TypeError)):
        creg.check_operands(spec, **args)
    assert runtime.launches("reg") == before


def _count_calls(monkeypatch):
    """Record each call of the wrapper (cost-only or not), each with
    operands the kernel would take."""
    calls = []
    inner = creg.pair_terms

    def counted(*a, **k):
        calls.append(bool(k.get("cost_only", False)))
        creg.check_operands(*a[:10], device=a[1].device)
        return inner(*a, **k)

    monkeypatch.setattr(creg, "pair_terms", counted)
    return calls


@pytest.mark.parametrize("iters", [0, 3])
def test_two_phase_calls_the_kernel_two_per_iteration_and_one(monkeypatch,
                                                              iters):
    """Phase 2 takes the terms once to assemble and once, cost only, for
    the trial; the tail once, cost only: 2·iterations + 1 launches on a
    card, iterations + 1 of them cost-only, each on operands the kernel
    takes."""
    init, cons, layers, spec, rcfg, scfg, fixed = \
        bm.solve_benchmark_problem(N, device=CPU)
    calls = _count_calls(monkeypatch)
    _, info = go.optimize_two_phase(init, cons, spec, layers, reg_cfg=rcfg,
                                    solver_cfg=scfg, reg_iterations=iters,
                                    fixed=fixed)
    assert info["n_registration_pairs"] > 0
    assert len(calls) == 2 * iters + 1 and sum(calls) == iters + 1


def test_register_pair_calls_the_kernel_iterations_and_two(problem,
                                                           monkeypatch):
    P = problem
    calls = _count_calls(monkeypatch)
    rcfg = reg.RegistrationConfig(max_points=Q, min_weight=0.5,
                                  iterations=4)
    out = reg.register_pair(P["spec"], P["layers"][0], P["layers"][1],
                            geo.relative(P["poses"][0], P["poses"][1]),
                            rcfg)
    assert len(calls) == rcfg.iterations + 2 and not any(calls)
    assert bool(torch.isfinite(out.T_A_B).all())


def test_snapshot_reports_reg_launches(monkeypatch):
    """The wrapper's entry point counts under "reg" in runtime, and
    launches added there show in snapshot() as "reg.launches"."""
    monkeypatch.setattr(runtime, "_launch_counts",
                        dict(runtime._launch_counts))
    assert creg._TERMS.name == "reg"
    before = runtime.snapshot()["counters"]["reg.launches"]
    runtime.add_launches("reg", 13)
    assert runtime.snapshot()["counters"]["reg.launches"] == before + 13
    assert runtime.launches("reg") == before + 13


def test_stacked_lookup_offsets_rows_by_the_pair_table(problem):
    """``stacked_slots``: a block of pair p found in table row j reads row
    j·R + its row there; one missing there, or outside the grid, -1."""
    P = problem
    spec, bi = P["spec"], P["bi"]
    slot_of = reg.stacked_slots(spec, bi, P["pair_j"], R)
    # rows 0, 3 and 4, a block past R (row 12), one outside the grid
    coords = torch.tensor([[-1, -2, -1], [-1, -1, 0], [-1, 0, -1],
                           [0, 0, 0], [spec.half_grid, 0, 0]],
                          dtype=torch.int32)
    got = slot_of(coords.expand(len(P["pairs"]), -1, -1).contiguous())
    for p, j in enumerate(P["pair_j"].tolist()):
        for c, b in enumerate(coords.tolist()):
            if not all(-spec.half_grid <= x < spec.half_grid for x in b):
                assert int(got[p, c]) == -1
                continue
            h = spec.half_grid
            row = int(bi[j, ((b[0] + h) * spec.grid_dim + b[1] + h)
                         * spec.grid_dim + b[2] + h])
            assert int(got[p, c]) == (row + j * R if row >= 0 else -1)
    assert (got[:, :3] >= 0).all() and (got[:, 3:] == -1).all()
    assert np.unique(got[got >= 0].numpy() // R).size > 1
