"""coxgraph_tpu_torch.ops.registration vs coxgraph_tpu.ops.registration on
the layers of tests/test_registration.py (the JAX package integrates
them; the port gets exact copies): the four cases of that file, each
gate held on the port's result, plus parity of the normal equations.

Tolerances (both sides f32): at generic poses the 12×12 H and the b of
``registration_normal_eq`` within 1e-4 of their max |·|, cost within
1e-5 relative, n_valid exact; residuals within 1e-5; the masked surface
samples the same voxels in the same order (centres within 1e-6: XLA
fuses the centre's multiply-add), their sdf within 1e-5;
``register_pair``'s T_A_B within 1e-4 of the reference's.

The lattice case: in self-registration at the identity every sample is
a voxel centre, so p·(1/s) − 0.5 lands on an integer and the trilinear
base voxel follows rounding noise; validity flips on the observed
region's shell and the one-sided derivative depends on the side taken.
The port computes p·f32(1/s), as jitted XLA does, and the jitted
reference fed the port's samples is its target there: n_valid exact, H
within 1e-4 of its max |·| (observed: 525 of 1,024 samples valid on both
sides, H within 2.5e-8), and both sides meet the reference's gates (cost
< 1e-6, |b| < 1e-4, H PSD). Which samples are valid is not a parity
target on the lattice: the reference's own sampler, jitted on its own,
finds 975 valid samples at the same centres where the normal equations
find 521, and run op by op (eager JAX divides by s exactly, so the base
voxel of a centre with a negative coordinate moves to the other side)
975."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.ops import registration as jreg
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.core import voxel as vx
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.ops import registration as reg
from coxgraph_tpu_torch.utils import interop
from test_registration import RCFG as JRCFG, SPEC as JSPEC, build_layer
from test_torch_mesh import one_thread  # noqa: F401

SPEC = interop.config_from(JSPEC)
RCFG = interop.config_from(JRCFG)
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(jl):
    return interop.layer_from_numpy(
        {f.name: np.asarray(getattr(jl, f.name))
         for f in dataclasses.fields(jl)}, CPU)


@pytest.fixture(scope="module")
def scenes():
    """The JAX layers of the four cases and their port copies."""
    scene = jsyn.default_scene()
    out = {}
    traj = jsyn.orbit_trajectory(4, scene.room_center, radius=2.5,
                                 sweep=jnp.pi / 2)
    out["single"] = (traj, build_layer(scene, traj, traj[0]))
    traj = jsyn.orbit_trajectory(8, scene.room_center, radius=2.5,
                                 sweep=jnp.pi)
    out["pair"] = (traj[0], traj[4], build_layer(scene, traj[:5], traj[0]),
                   build_layer(scene, traj[3:], traj[4]))
    traj = jsyn.orbit_trajectory(6, scene.room_center, radius=2.5,
                                 sweep=0.75 * jnp.pi)
    out["stay"] = (traj[0], traj[3], build_layer(scene, traj[:4], traj[0]),
                   build_layer(scene, traj[2:], traj[3]))
    return out


def _voxels(pts):
    return np.floor(np.asarray(pts) / JSPEC.voxel_size).astype(int)


def test_surface_point_extraction(scenes):
    traj, jl = scenes["single"]
    pl = _port(jl)
    pts, mask = reg.extract_surface_points(SPEC, pl, RCFG)
    m = mask.numpy()
    assert m.sum() > 500
    world = geo.transform_points(_t(traj[0]), pts)
    sdf = syn.scene_sdf(syn.default_scene(CPU), world).numpy()[m]
    assert np.quantile(np.abs(sdf), 0.9) < 2.5 * SPEC.voxel_size

    jpts, jmask = jreg.extract_surface_points(JSPEC, jl, JRCFG)
    np.testing.assert_array_equal(m, np.asarray(jmask))
    np.testing.assert_array_equal(_voxels(pts.numpy()[m]),
                                  _voxels(np.asarray(jpts)[m]))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-6,
                               rtol=0)
    for a, b in zip(reg.surface_point_cache(SPEC, pl, RCFG),
                    jreg.surface_point_cache(JSPEC, jl, JRCFG)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pose_err(a, b):
    d = geo.se3_log(geo.relative(_t(a).double(), _t(b).double()))
    return float(d[3:].norm()), float(d[:3].norm())


def test_register_pair_recovers_perturbation(scenes):
    T_A, T_B, jA, jB = scenes["pair"]
    T_true = jgeo.relative(T_A, T_B)
    pert = jgeo.se3_exp(jnp.array([0.02, -0.015, 0.03, 0.06, -0.04, 0.05]))
    T_init = jgeo.compose(T_true, pert)
    res = reg.register_pair(SPEC, _port(jA), _port(jB), _t(T_init), RCFG)
    n0 = float(geo.se3_log(geo.relative(_t(T_init), _t(T_true))).norm())
    n1 = float(geo.se3_log(geo.relative(res.T_A_B, _t(T_true))).norm())
    assert int(res.n_inliers) > 200
    assert float(res.cost) < float(res.initial_cost)
    assert n1 < 0.35 * n0, (n0, n1)
    assert n1 < 0.035

    jres = jreg.register_pair(JSPEC, jA, jB, T_init, JRCFG)
    dt, dr = _pose_err(res.T_A_B, jres.T_A_B)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    assert int(res.n_inliers) == int(jres.n_inliers)
    assert abs(float(res.cost) - float(jres.cost)) <= 1e-4 * float(jres.cost)
    assert abs(float(res.initial_cost) - float(jres.initial_cost)) <= \
        1e-5 * float(jres.initial_cost)


def test_register_pair_identity_stays_put(scenes):
    T_A, T_B, jA, jB = scenes["stay"]
    T_true = jgeo.relative(T_A, T_B)
    res = reg.register_pair(SPEC, _port(jA), _port(jB), _t(T_true), RCFG)
    drift = float(geo.se3_log(geo.relative(res.T_A_B, _t(T_true))).norm())
    assert drift < 0.5 * SPEC.voxel_size
    jres = jreg.register_pair(JSPEC, jA, jB, T_true, JRCFG)
    dt, dr = _pose_err(res.T_A_B, jres.T_A_B)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)


@pytest.mark.parametrize("move", [0, 1, 2])
def test_registration_normal_eq_matches_jax(scenes, move):
    T_A, T_B, jA, jB = scenes["pair"]
    T_AB = jgeo.compose(jgeo.relative(T_A, T_B), jgeo.se3_exp(jnp.array(
        [0.01 * move, -0.02, 0.015, 0.03, 0.02 * move, -0.01])))
    T_OA = jgeo.se3_exp(jnp.array([0.1, -0.2, 0.05, 0.3, -0.1, 0.2]) * move)
    T_OB = jgeo.compose(T_OA, T_AB)
    pts, sdf, m = jreg.surface_point_cache(JSPEC, jA, JRCFG)
    H, b, cost, n = jreg.registration_normal_eq(JSPEC, jB, pts, sdf, m,
                                                T_OA, T_OB, 0.1)
    args = (_t(pts), _t(sdf), _t(m), _t(T_OA), _t(T_OB))
    Hp, bp, cp, n_p = reg.registration_normal_eq(SPEC, _port(jB), *args,
                                                 0.1)
    assert int(n_p) == int(n) > 200
    assert _relerr(Hp, H) <= 1e-4 and _relerr(bp, b) <= 1e-4
    assert abs(float(cp) - float(cost)) <= 1e-5 * float(cost)
    r, ok = jreg.registration_residuals(JSPEC, jB, pts, sdf, m, T_OA, T_OB)
    rp, okp = reg.registration_residuals(SPEC, _port(jB), *args)
    np.testing.assert_array_equal(okp.numpy(), np.asarray(ok))
    np.testing.assert_allclose(rp.numpy(), np.asarray(r), atol=1e-5,
                               rtol=0)


def test_registration_normal_eq_gradient_sanity(scenes):
    """Self-registration at the identity: the residuals vanish (the
    reference's gates); on the lattice the port is held to the jitted
    reference fed the same samples."""
    _, jl = scenes["single"]
    pl = _port(jl)
    pts, mask = reg.extract_surface_points(SPEC, pl, RCFG)
    sA, _, okA = vx.sample_tsdf_trilinear(SPEC, pl, pts)
    H, b, cost, n = reg.registration_normal_eq(
        SPEC, pl, pts, torch.where(okA, sA, 0.0), mask & okA,
        geo.identity(CPU), geo.identity(CPU))
    assert float(cost) < 1e-6
    assert float(b.abs().max()) < 1e-4
    assert np.linalg.eigvalsh(H.double().numpy()).min() > -1e-4

    jH, jb, jcost, jn = jreg.registration_normal_eq(
        JSPEC, jl, pts.numpy(), sA.numpy() * okA.numpy(),
        (mask & okA).numpy(), jgeo.identity(), jgeo.identity())
    assert float(jcost) < 1e-6 and float(jnp.abs(jb).max()) < 1e-4
    assert int(n) == int(jn)
    assert _relerr(H, jH) <= 1e-4


def test_register_pair_walks_away_beyond_its_basin(scenes):
    """A fault of the reference, shown: register_pair takes every
    Gauss-Newton step (damping 1e-3, only non-finite or ‖δ‖ > 1 steps
    dropped, no cost test), so from 1.5× the perturbation of
    test_register_pair_recovers_perturbation its first step jumps into a
    false minimum: the cost falls (2.15 → 1.56) while the pose error
    grows (0.144 → 0.356; observed). The port reproduces the reference
    (T_A_B within 1e-4, inliers exact) — the fault is carried, not
    fixed. At the stock spec (5 cm voxels) the basin is narrower still:
    from test_registration's own perturbation, stock submaps 0 and 1 go
    0.096 → 0.594 in both packages (chip_smoke.py phase 11)."""
    T_A, T_B, jA, jB = scenes["pair"]
    T_true = jgeo.relative(T_A, T_B)
    pert = jgeo.se3_exp(1.5 * jnp.array([0.02, -0.015, 0.03, 0.06, -0.04,
                                         0.05]))
    T_init = jgeo.compose(T_true, pert)
    jres = jreg.register_pair(JSPEC, jA, jB, T_init, JRCFG)
    res = reg.register_pair(SPEC, _port(jA), _port(jB), _t(T_init), RCFG)
    for T, cost, cost0 in ((_t(jres.T_A_B), jres.cost, jres.initial_cost),
                           (res.T_A_B, res.cost, res.initial_cost)):
        e0 = float(geo.se3_log(geo.relative(_t(T_init), _t(T_true))).norm())
        e1 = float(geo.se3_log(geo.relative(T, _t(T_true))).norm())
        assert float(cost) < float(cost0) and e1 > 2 * e0, (e0, e1)
    dt, dr = _pose_err(res.T_A_B, jres.T_A_B)
    assert dt <= 1e-4 and dr <= 1e-4, (dt, dr)
    assert int(res.n_inliers) == int(jres.n_inliers)
