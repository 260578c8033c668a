"""coxgraph_tpu_torch.server.global_opt vs coxgraph_tpu.server.global_opt
at the bench solve point cut to 8 submaps (eval.benchmarks
.solve_benchmark_problem(8): 13 overlapping pairs, the odometry chain
drawn from default_rng(7)). The JAX problem is carried across with
utils.interop, so both solves start from identical inputs; the port's
own solve_benchmark_problem is held to the JAX one separately.

Tolerances (both sides f32): overlapping pairs, AABBs and block counts
identical; poses within 1e-4 m and 1e-4 rad; cost traces, the phase-1
and relpose costs within 1e-4 relative (phase 1 ends at an exact fit,
cost ~1e-11, so it is held to 1e-8 absolute); candidate checks: inlier
counts exact, rms within 1e-4 voxels. Chunked and fused phase 2 in the
port: equal, bit for bit. The port's solve_benchmark_problem: poses and
measurements within 1e-6, sdf within 1e-6 (torch's and XLA's sin/cos
differ in the last bit), weights within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.eval import benchmarks as jbm
from coxgraph_tpu.server import global_opt as jgo
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.eval import benchmarks as bm
from coxgraph_tpu_torch.server import global_opt as go
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import interop
from test_torch_mesh import one_thread  # noqa: F401
from test_torch_solver import pose_errors

CPU = torch.device("cpu")
N = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _layers(jlayers):
    return interop.layers_from_numpy(
        [{f.name: np.asarray(getattr(l, f.name))
          for f in dataclasses.fields(l)} for l in jlayers], CPU)


@pytest.fixture(scope="module")
def problem():
    """(JAX problem, the same problem in the port, the JAX solve)."""
    J = jbm.solve_benchmark_problem(N)
    init, cons, layers, spec, rcfg, scfg, fixed = J
    P = (_t(init),
         interop.constraints_from_numpy(
             {k: np.asarray(v) for k, v in interop.flatten(cons).items()},
             CPU),
         _layers(layers), interop.config_from(spec),
         interop.config_from(rcfg), interop.config_from(scfg), _t(fixed))
    return J, P, _solve(jgo, J)


def _solve(mod, X, **kw):
    init, cons, layers, spec, rcfg, scfg, fixed = X
    kw.setdefault("reg_cfg", rcfg)
    return mod.optimize_two_phase(
        init, cons, spec, layers, solver_cfg=scfg, registration_weight=30.0,
        reg_iterations=6, fixed=fixed, **kw)


def _close(a, b, rel=1e-4, floor=0.0):
    return abs(float(a) - float(b)) <= max(rel * abs(float(b)), floor)


def test_solve_benchmark_problem_matches_jax(problem):
    J, _, _ = problem
    init, cons, layers, spec, rcfg, scfg, fixed = \
        bm.solve_benchmark_problem(N, device=CPU)
    assert (spec, rcfg, scfg) == tuple(
        interop.config_from(c) for c in J[3:6])
    np.testing.assert_allclose(init.numpy(), np.asarray(J[0]), atol=1e-6,
                               rtol=0)
    for name, a in interop.flatten(J[1]).items():
        np.testing.assert_allclose(getattr(cons, name).numpy(),
                                   np.asarray(a), atol=1e-6, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(fixed.numpy(), np.asarray(J[6]))
    assert len(layers) == N
    for pl, jl in zip(layers, J[2]):
        for f in dataclasses.fields(jl):
            a, b = np.asarray(getattr(jl, f.name)), getattr(pl, f.name)
            np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0,
                                       err_msg=f.name)


@pytest.mark.parametrize("max_pairs,skip", [(0, None), (5, None),
                                            (0, [(1, 0), (2, 3)])])
def test_find_overlapping_pairs_identical(problem, max_pairs, skip):
    J, P, _ = problem
    want = jgo.find_overlapping_pairs(J[3], J[2], J[0], max_pairs=max_pairs,
                                      skip_adjacent_same_client=skip)
    got = go.find_overlapping_pairs(P[3], P[2], P[0], max_pairs=max_pairs,
                                    skip_adjacent_same_client=skip)
    assert got == want and len(got) > 0
    aabbs, counts = go.submap_geometry(P[3], P[2])
    for k in range(N):
        np.testing.assert_array_equal(aabbs[k],
                                      jgo.submap_aabb(J[3], J[2][k]))
        np.testing.assert_array_equal(go.submap_aabb(P[3], P[2][k]),
                                      aabbs[k])
        assert counts[k] == int(J[2][k].num_blocks)
        np.testing.assert_array_equal(
            go.transformed_aabb(aabbs[k], P[0][k].numpy()),
            jgo.transformed_aabb(aabbs[k], np.asarray(J[0][k])))


def test_overlap_pairs_skip_geometry_less_submaps(problem):
    """A None aabb (a submap without cached geometry yet) takes no
    pairs, as in the reference."""
    J, P, _ = problem
    aabbs, blocks = go.submap_geometry(P[3], P[2])
    racy = list(aabbs)
    racy[N - 1] = None
    ref = jgo.find_overlapping_pairs(J[3], J[2], J[0], aabbs=racy,
                                     n_blocks=blocks)
    got = go.find_overlapping_pairs(P[3], P[2], P[0], aabbs=racy,
                                    n_blocks=blocks)
    full = go.find_overlapping_pairs(P[3], P[2], P[0], aabbs=aabbs,
                                     n_blocks=blocks)
    assert got == ref == [(i, j) for (i, j) in full if N - 1 not in (i, j)]
    assert len(got) < len(full)


def test_phase1_and_zero_weight_short_circuit(problem):
    J, P, _ = problem
    jposes, jinfo = jgo.optimize_two_phase(
        J[0], J[1], J[3], J[2], reg_cfg=J[4], solver_cfg=J[5],
        registration_weight=0.0, fixed=J[6])
    poses, info = go.optimize_two_phase(
        P[0], P[1], P[3], P[2], reg_cfg=P[4], solver_cfg=P[5],
        registration_weight=0.0, fixed=P[6])
    assert set(info) == set(jinfo) == {"phase1_cost", "n_registration_pairs"}
    assert info["n_registration_pairs"] == 0
    assert _close(info["phase1_cost"], jinfo["phase1_cost"], floor=1e-8)
    dt, dr = pose_errors(poses, jposes)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    res = pg.optimize(P[0], P[1], P[5], fixed=P[6])
    assert torch.equal(res.poses, poses)


def test_two_phase_matches_jax(problem):
    J, P, (jposes, jinfo) = problem
    poses, info = _solve(go, P)
    assert set(info) == set(jinfo)
    assert info["n_registration_pairs"] == jinfo["n_registration_pairs"] \
        == 13
    assert _close(info["phase1_cost"], jinfo["phase1_cost"], floor=1e-8)
    assert _close(info["phase2_relpose_cost"], jinfo["phase2_relpose_cost"])
    tr, jtr = info["phase2_cost_trace"], jinfo["phase2_cost_trace"]
    assert len(tr) == len(jtr) == 7
    np.testing.assert_allclose(tr, jtr, rtol=1e-4)
    for a, b in zip(tr[:-1], tr[1:]):
        assert b <= a * (1 + 1e-5), tr
    dt, dr = pose_errors(poses, jposes)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)


def test_phase2_chunked_equals_fused(problem):
    """phase2_dispatch_iters splits the loop and changes nothing: the
    same ops in the same order (2 even chunks, 4 with a remainder)."""
    _, P, _ = problem
    ref_poses, ref_info = _solve(go, P)
    for di in (2, 4):
        poses, info = _solve(go, P, reg_cfg=dataclasses.replace(
            P[4], phase2_dispatch_iters=di))
        assert torch.equal(poses, ref_poses), di
        assert info == ref_info, di


def test_caches_change_nothing(problem):
    """Warm registration-point caches and a held stacked field give the
    cold solve's result exactly."""
    _, P, _ = problem
    ref_poses, ref_info = _solve(go, P)
    caches, stack = [None] * N, {}
    for _ in range(2):
        poses, info = _solve(go, P, reg_caches=caches, stack_cache=stack)
        assert torch.equal(poses, ref_poses) and info == ref_info
    assert all(c is not None for c in caches[:N - 1])
    assert stack["key"][0] == min(P[4].max_reg_blocks, P[3].max_blocks)


def test_stack_cache_keeps_its_keyed_layers(problem):
    """The stacked field is keyed on the layers' ids, so the cache holds
    the keyed tensors: a layer dropped by its caller cannot hand its id to
    a new layer while the entry stands (coxgraph_tpu/server/global_opt.py
    keys on ids without holding them, ROADMAP queue 3)."""
    import gc
    import weakref

    _, P, _ = problem
    ref_poses, _ = _solve(go, P)
    stack = {}
    copies = [dataclasses.replace(l, sdf=l.sdf.clone()) for l in P[2]]
    probe = weakref.ref(copies[0].sdf)
    _solve(go, P[:2] + (copies,) + P[3:], stack_cache=stack)
    del copies
    gc.collect()
    assert probe() is not None
    poses, _ = _solve(go, P, stack_cache=stack)
    assert torch.equal(poses, ref_poses)


def test_height_priors_in_both_phases(problem):
    """Height priors enter phase 1 and phase 2 (the reference's cost
    trace and poses, and the priors pull z toward 0)."""
    J, P, _ = problem
    jh = jpg.HeightConstraints.empty(N)
    for k in range(N):
        jh = jh.add(k, 0.0, stddev=0.05)
    h = interop.heights_from_numpy(
        {k: np.asarray(v) for k, v in interop.flatten(jh).items()}, CPU)
    jposes, jinfo = _solve(jgo, J, heights=jh)
    poses, info = _solve(go, P, heights=h)
    np.testing.assert_allclose(info["phase2_cost_trace"],
                               jinfo["phase2_cost_trace"], rtol=1e-4)
    dt, dr = pose_errors(poses, jposes)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    free, _ = _solve(go, P)
    assert float(poses[:, 6].abs().max()) < float(free[:, 6].abs().max())


def test_check_loop_closure_candidates_matches_jax(problem):
    J, P, _ = problem
    T_true = jgeo.relative(J[0][2], J[0][3])
    T_bad = jgeo.compose(T_true, jgeo.se3_exp(jnp.array(
        [0.0, 0.0, 0.3, 0.4, -0.2, 0.1])))
    cands = [(2, 3, T_true), (2, 3, T_bad), (0, 5, T_true)]
    caches = [None] * N
    want = jgo.check_loop_closure_candidates(J[3], J[2], cands, J[4])
    got = go.check_loop_closure_candidates(
        P[3], P[2], [(i, j, _t(T)) for i, j, T in cands], P[4],
        caches=caches)
    assert caches[2] is not None and caches[0] is not None
    assert go.check_loop_closure_candidates(
        P[3], P[2], [(i, j, np.asarray(T)) for i, j, T in cands], P[4],
        caches=caches) == got
    for g, w in zip(got, want):
        assert (g["i"], g["j"], g["n_inliers"], g["ok"]) == \
            (w["i"], w["j"], w["n_inliers"], w["ok"])
        if np.isfinite(w["rms"]):
            assert abs(g["rms"] - w["rms"]) <= 1e-4
        else:
            assert not np.isfinite(g["rms"])
    assert got[0]["ok"] and not got[1]["ok"]


def test_evaluate_residuals_matches_jax(problem):
    J, P, (jposes, _) = problem
    np.testing.assert_allclose(
        go.evaluate_residuals(_t(jposes), P[1]),
        jgo.evaluate_residuals(jposes, J[1]), atol=1e-4, rtol=1e-4)
