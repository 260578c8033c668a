"""coxgraph_tpu_torch.solver.pose_graph vs coxgraph_tpu.solver.pose_graph:
the ten cases of tests/test_solver.py, each solved by both packages from
the same inputs (the JAX test's own fixtures, carried across with
utils.interop), the JAX test's gates held on the port's result, and the
normal equations at a fixed pose set.

Tolerances (both sides f32): normal equations max |ΔH| ≤ 1e-4·max|H|,
max |Δb| ≤ 1e-4·max|b|, cost within 1e-5 relative; solved poses within
1e-4 m in translation and 1e-4 rad in rotation; final costs within 1e-4
relative, or 1e-8 absolute where the reference itself converges to an
exact fit (costs of ~1e-14 are rounding noise on either side).

One case needs a looser pose bound: the drifted-z chain with height
priors (test_height_constraints_pin_drifted_z) weighs its priors 1e4
against 1e-2 for the chain, so H's condition number is ~1e6 and an f32
Cholesky step moves the weakly observed x coordinates by amounts that
differ across backends; the two solves reach costs equal to 3e-10
relative at poses 1.24e-4 m apart along x (observed), held at 5e-4 m."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.solver import pose_graph as pg
from coxgraph_tpu_torch.utils import interop
from test_solver import chain_poses, perturb
from test_torch_mesh import one_thread  # noqa: F401

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _pool(jpool):
    arrays = {k: np.asarray(v) for k, v in interop.flatten(jpool).items()}
    if isinstance(jpool, jpg.HeightConstraints):
        return interop.heights_from_numpy(arrays, CPU)
    return interop.constraints_from_numpy(arrays, CPU)


def pose_errors(a, b):
    """(max translation m, max rotation rad) between pose sets (N,7)."""
    a = torch.tensor(np.asarray(a), dtype=torch.float64)
    b = torch.tensor(np.asarray(b), dtype=torch.float64)
    rot = geo.so3_log(geo.rotation(geo.relative(a, b))).norm(dim=-1)
    return (float((a[:, 4:] - b[:, 4:]).norm(dim=-1).max()),
            float(rot.max()))


def _close_cost(a, b):
    a, b = float(a), float(b)
    return abs(a - b) <= max(1e-4 * abs(b), 1e-8)


def solve_both(poses, c, cfg=jpg.SolverConfig(), fixed=None, heights=None,
               pose_tol=1e-4):
    """optimize in both packages → (JAX result, port result), poses and
    costs held to each other."""
    jres = jpg.optimize(poses, c, cfg, fixed=fixed, heights=heights)
    pres = pg.optimize(
        _t(poses), _pool(c), interop.config_from(cfg),
        fixed=None if fixed is None else _t(fixed),
        heights=None if heights is None else _pool(heights))
    dt, dr = pose_errors(pres.poses, jres.poses)
    assert dt <= pose_tol and dr <= 1e-4, (dt, dr)
    assert _close_cost(pres.cost, jres.cost), (float(pres.cost),
                                               float(jres.cost))
    assert _close_cost(pres.initial_cost, jres.initial_cost)
    assert int(pres.iterations) == int(jres.iterations)
    return jres, pres


def _err_norms(poses, gt):
    d = geo.se3_log(geo.relative(poses, _t(gt)))
    return d


def test_odometry_chain_recovers_exactly():
    """Exact-fit constraints: the residuals of the converged chain are
    ~0, where so3_log's norm has no derivative — the case the port's
    written-out Jacobians must survive."""
    gt, rels = chain_poses(10, jax.random.PRNGKey(0))
    c = jpg.RelPoseConstraints.empty(32)
    for i in range(9):
        c = c.add(i, i + 1, rels[i])
    noisy = perturb(gt, jax.random.PRNGKey(1))
    _, res = solve_both(noisy, c, jpg.SolverConfig(iterations=20))
    assert float(res.cost) < 1e-8
    assert float(_err_norms(res.poses, gt).abs().max()) < 1e-3


def test_loop_closure_distributes_drift():
    gt, rels = chain_poses(8, jax.random.PRNGKey(2))
    c = jpg.RelPoseConstraints.empty(32)
    for i in range(7):
        drift = jgeo.se3_exp(jnp.array([0.0, 0.0, 0.02, 0.05, 0.0, 0.0]))
        c = c.add(i, i + 1, jgeo.compose(rels[i], drift))
    c = c.add(0, 7, jgeo.relative(gt[0], gt[7]),
              sqrt_info=10.0 * jnp.eye(6))
    _, res = solve_both(gt, c, jpg.SolverConfig(iterations=25))
    end_err = _err_norms(res.poses[7:8], np.asarray(gt)[7:8])
    assert float(end_err.norm()) < 0.02
    assert float(res.cost) < float(res.initial_cost)


def test_invalid_constraints_ignored():
    gt, rels = chain_poses(5, jax.random.PRNGKey(3))
    c = jpg.RelPoseConstraints.empty(16)
    for i in range(4):
        c = c.add(i, i + 1, rels[i])
    noisy = perturb(gt, jax.random.PRNGKey(4))
    _, res1 = solve_both(noisy, c)
    c2 = jpg.RelPoseConstraints(
        i=c.i.at[10].set(1), j=c.j.at[10].set(3),
        T_meas=c.T_meas.at[10].set(jgeo.se3_exp(jnp.ones(6))),
        sqrt_info=c.sqrt_info, valid=c.valid, count=c.count)
    _, res2 = solve_both(noisy, c2)
    np.testing.assert_allclose(res1.poses.numpy(), res2.poses.numpy(),
                               atol=1e-6)


def test_huber_rejects_outlier():
    gt, rels = chain_poses(6, jax.random.PRNGKey(5))
    c = jpg.RelPoseConstraints.empty(16)
    for i in range(5):
        c = c.add(i, i + 1, rels[i], sqrt_info=10.0 * jnp.eye(6))
    c = c.add(0, 5, jgeo.se3_exp(jnp.array([0.5, 0.5, 0.5, 3.0, -2.0, 1.0])))
    noisy = perturb(gt, jax.random.PRNGKey(6), rot=0.02, trans=0.05)
    _, plain = solve_both(noisy, c, jpg.SolverConfig(iterations=25))
    _, rob = solve_both(noisy, c, jpg.SolverConfig(iterations=25,
                                                   huber_delta=0.3))

    def ate(poses):
        d = (poses[:, 4:] - _t(gt)[:, 4:]).norm(dim=-1)
        return float(torch.sqrt(torch.mean(d ** 2)))

    assert ate(rob.poses) < ate(plain.poses)
    assert ate(rob.poses) < 0.2


def test_yaw_only_mode():
    true_offset = jgeo.from_xyzyaw(jnp.array([1.0, -2.0, 0.5, 0.8]))
    poses = jnp.stack([jgeo.identity(), true_offset])
    c = jpg.RelPoseConstraints.empty(4).add(0, 1, true_offset)
    noisy = poses.at[1].set(jgeo.compose(
        true_offset, jgeo.from_xyzyaw(jnp.array([0.3, 0.3, -0.2, 0.4]))))
    _, res = solve_both(noisy, c, jpg.SolverConfig(iterations=15,
                                                   yaw_only=True))
    err = geo.se3_log(geo.relative(res.poses[1], _t(true_offset)))
    assert float(err.norm()) < 1e-4
    back = geo.from_xyzyaw(geo.to_xyzyaw(res.poses[1]))
    err2 = geo.se3_log(geo.relative(back, res.poses[1]))
    assert float(err2[:3].norm()) < 1e-5


def test_fixed_poses_respected():
    gt, rels = chain_poses(5, jax.random.PRNGKey(8))
    c = jpg.RelPoseConstraints.empty(8)
    for i in range(4):
        c = c.add(i, i + 1, rels[i])
    noisy = perturb(gt, jax.random.PRNGKey(9))
    fixed = jnp.array([True, False, False, True, False])
    _, res = solve_both(noisy, c, jpg.SolverConfig(iterations=10),
                        fixed=fixed)
    for k in (0, 3):
        np.testing.assert_allclose(res.poses[k].numpy(),
                                   np.asarray(noisy[k]), atol=1e-7)


def _drifted_z_chain(n=6):
    c = jpg.RelPoseConstraints.empty(16)
    for i in range(n - 1):
        T_meas = jgeo.make(jnp.array([1.0, 0, 0, 0]),
                           jnp.array([1.0, 0.0, 0.2]))
        c = c.add(i, i + 1, T_meas, sqrt_info=jnp.eye(6) * 0.1)
    h = jpg.HeightConstraints.empty(16)
    for i in range(n):
        h = h.add(i, 0.0, stddev=0.01)
    drifted = jnp.stack([
        jgeo.make(jnp.array([1.0, 0, 0, 0]),
                  jnp.array([float(i), 0.0, 0.2 * i])) for i in range(n)])
    return drifted, c, h


def test_height_constraints_pin_drifted_z():
    drifted, c, h = _drifted_z_chain()
    _, res = solve_both(drifted, c, jpg.SolverConfig(iterations=25),
                        heights=h, pose_tol=5e-4)
    assert float(res.poses[:, 6].abs().max()) < 0.02
    _, res0 = solve_both(drifted, c, jpg.SolverConfig(iterations=25))
    assert float(res0.poses[:, 6].abs().max()) > 0.15


def test_height_constraints_empty_pool_is_noop():
    gt, rels = chain_poses(5, jax.random.PRNGKey(3))
    c = jpg.RelPoseConstraints.empty(8)
    for i in range(4):
        c = c.add(i, i + 1, rels[i])
    noisy = perturb(gt, jax.random.PRNGKey(4))
    _, res = solve_both(noisy, c, jpg.SolverConfig(iterations=20),
                        heights=jpg.HeightConstraints.empty(4))
    assert float(res.cost) < 1e-8


def test_pool_overflow_watermark_and_solve_sanity():
    c = pg.RelPoseConstraints.empty(2, CPU)
    jc = jpg.RelPoseConstraints.empty(2)
    for k in range(5):
        c = c.add(k, k + 1, geo.identity(CPU))
        jc = jc.add(k, k + 1, jgeo.identity())
    assert c.capacity == 2 and int(c.count) == 5 and c.num_dropped() == 3
    assert int(c.valid.sum()) == 2
    for name, a in interop.flatten(jc).items():
        np.testing.assert_array_equal(getattr(c, name).numpy(),
                                      np.asarray(a), err_msg=name)
    h = pg.HeightConstraints.empty(2, CPU)
    for k in range(3):
        h = h.add(k, 0.5)
    assert h.num_dropped() == 1
    poses = jnp.tile(jgeo.identity()[None], (3, 1))
    _, res = solve_both(poses, jc, jpg.SolverConfig(iterations=5))
    assert bool(torch.isfinite(res.poses).all())
    assert float(res.cost) <= float(res.initial_cost) + 1e-9


def test_height_prior_only_pose_is_not_gauge_frozen():
    poses = jnp.stack([jgeo.identity(),
                       jgeo.make(jnp.asarray([1.0, 0, 0, 0]),
                                 jnp.asarray([1.0, 0.0, 0.5]))])
    cons = jpg.RelPoseConstraints.empty(4)
    h = jpg.HeightConstraints.empty(4).add(1, 0.0, stddev=0.01)
    _, res = solve_both(poses, cons, jpg.SolverConfig(iterations=10),
                        heights=h)
    assert abs(float(res.poses[1, 6])) < 0.05
    np.testing.assert_allclose(res.poses[1, 4:6].numpy(), [1.0, 0.0],
                               atol=1e-5)
    np.testing.assert_allclose(res.poses[0].numpy(),
                               geo.identity(CPU).numpy(), atol=1e-6)


NORMAL_EQ_CFGS = {
    "plain": jpg.SolverConfig(),
    "huber": jpg.SolverConfig(huber_delta=0.3),
    "yaw_only": jpg.SolverConfig(yaw_only=True),
}


@pytest.mark.parametrize("name", list(NORMAL_EQ_CFGS))
@pytest.mark.parametrize("with_heights", [False, True],
                         ids=["no_heights", "heights"])
def test_normal_equations_match_jax(name, with_heights):
    """H, b and cost at a perturbed chain with a drifted odometry, two
    loop closures (one of them a gross outlier), an invalid row and
    height priors."""
    jcfg = NORMAL_EQ_CFGS[name]
    gt, rels = chain_poses(8, jax.random.PRNGKey(11))
    c = jpg.RelPoseConstraints.empty(16)
    drift = jgeo.se3_exp(jnp.array([0.01, -0.02, 0.03, 0.05, 0.0, -0.04]))
    for i in range(7):
        c = c.add(i, i + 1, jgeo.compose(rels[i], drift),
                  sqrt_info=(1.0 + i) * jnp.eye(6))
    c = c.add(0, 7, jgeo.relative(gt[0], gt[7]), 10.0 * jnp.eye(6))
    c = c.add(2, 5, jgeo.se3_exp(jnp.array([0.6, -0.4, 0.5, 2.0, 1.0,
                                            -1.5])))
    poses = perturb(gt, jax.random.PRNGKey(12))
    h = jpg.HeightConstraints.empty(8)
    for i in range(1, 8, 2):
        h = h.add(i, 0.1 * i, stddev=0.2)
    fixed = jnp.zeros((8,), bool).at[0].set(True)
    H, b, cost = jpg._build_normal_equations(
        poses, c, jcfg, fixed, h if with_heights else None)
    Hp, bp, cp = pg._build_normal_equations(
        _t(poses), _pool(c), interop.config_from(jcfg), _t(fixed),
        _pool(h) if with_heights else None)
    H, b = np.asarray(H), np.asarray(b)
    assert np.abs(Hp.numpy() - H).max() <= 1e-4 * np.abs(H).max()
    assert np.abs(bp.numpy() - b).max() <= 1e-4 * np.abs(b).max()
    assert abs(float(cp) - float(cost)) <= 1e-5 * float(cost)
    for fn in ("_total_cost",):
        want = getattr(jpg, fn)(poses, c, jcfg, h if with_heights else None)
        got = getattr(pg, fn)(_t(poses), _pool(c), interop.config_from(jcfg),
                              _pool(h) if with_heights else None)
        assert abs(float(got) - float(want)) <= 1e-5 * float(want)
    np.testing.assert_allclose(
        pg.residuals(_t(poses), _pool(c)).numpy(),
        np.asarray(jpg.residuals(poses, c)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        pg.height_residuals(_t(poses), _pool(h)).numpy(),
        np.asarray(jpg.height_residuals(poses, h)), rtol=0, atol=1e-5)


def _jacobian_probes():
    """Tangents ξ whose rotation angles run from 1e-5 to 3 rad."""
    rng = np.random.default_rng(13)
    xi = rng.normal(size=(40, 6)).astype(np.float32)
    ang = np.geomspace(1e-5, 3.0, 40).astype(np.float32)
    xi[:, :3] *= (ang / np.linalg.norm(xi[:, :3], axis=1))[:, None]
    xi[:, 3:] *= 2.0
    return ang, xi


def _fd_right_jacobian_inv(xi):
    """∂ log(exp(ξ)·exp(δ)) / ∂δ at 0 by central differences in float64
    through the port's geometry (independent of the series)."""
    x = torch.from_numpy(xi).double()
    E = geo.se3_exp(x)
    h = 1e-6
    cols = []
    for k in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[k] = h
        plus = geo.se3_log(geo.compose(E, geo.se3_exp(d)))
        minus = geo.se3_log(geo.compose(E, geo.se3_exp(-d)))
        cols.append((plus - minus) / (2 * h))
    return torch.stack(cols, dim=-1).numpy()


def _exact_log(xi):
    """log(exp(ξ)) computed in float64, rounded to f32."""
    x = torch.from_numpy(xi).double()
    return geo.se3_log(geo.se3_exp(x)).float()


def test_right_jacobian_inverse_matches_finite_differences():
    """se3_right_jacobian_inv in f32 against float64 central differences
    at rotations from 1e-5 to 3 rad (observed max |Δ| 2.1e-7)."""
    _, xi = _jacobian_probes()
    truth = _fd_right_jacobian_inv(xi)
    got = pg.se3_right_jacobian_inv(_exact_log(xi)).numpy()
    assert np.abs(got - truth).max() <= 1e-5 * np.abs(truth).max()


def test_reference_geometry_loses_precision_at_small_angles():
    """A fault of the reference, shown: se3_exp and se3_log switch to
    their Taylor forms only below θ² = 1e-8, so for 1e-4 < θ < 1e-2 rad
    they evaluate (θ − sin θ)/θ³ and (1 − h·cot h)/θ² in f32, where both
    cancel catastrophically. log(exp(ξ)) then misses ξ's translation by
    up to ~3e-4 m at |v| of a few metres (observed 2.8e-4), and
    jax.jacfwd through se3_log gives relative-pose Jacobians off by up to
    ~6.5e-4 (entries of order 1); at θ ≥ 0.05 rad both agree with
    float64 to ~1e-5. The port keeps the reference's geometry (parity),
    but its written-out J_r⁻¹ has no such term: given an exact ξ it is
    within 1e-5 of float64 at every angle."""
    ang, xi = _jacobian_probes()
    truth = _fd_right_jacobian_inv(xi)
    band = (ang > 1e-4) & (ang < 1e-2)
    wide = ang >= 0.05

    rt = np.asarray(jax.vmap(jgeo.se3_log)(jax.vmap(jgeo.se3_exp)(
        jnp.asarray(xi))))
    rt_err = np.abs(rt - _exact_log(xi).numpy()).max(axis=1)
    assert rt_err[band].max() > 1e-4
    assert rt_err[wide].max() < 1e-5

    def f(x, d):
        return jgeo.se3_log(jgeo.compose(jgeo.se3_exp(x), jgeo.se3_exp(d)))

    ref = np.asarray(jax.vmap(jax.jacfwd(f, argnums=1))(
        jnp.asarray(xi), jnp.zeros((40, 6))))
    ref_err = np.abs(ref - truth).max(axis=(1, 2))
    assert ref_err[band].max() > 1e-4
    assert ref_err[wide].max() < 1e-5
    got = pg.se3_right_jacobian_inv(_exact_log(xi)).numpy()
    assert np.abs(got - truth).max(axis=(1, 2)).max() < 1e-5
