"""coxgraph_tpu_torch.core.geometry vs coxgraph_tpu.core.geometry on the
same seeded inputs (numpy → both). Tolerance: atol 1e-6 (f32 ops in the
same order; only the last bit may differ where a backend fuses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu_torch.core import geometry as geo

ATOL = 1e-6
CPU = torch.device("cpu")


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(scale=1.0, size=(n, 3)).astype(np.float32)
    return np.concatenate([q, t], axis=-1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


A = _poses(64, 0)
B = _poses(64, 1)
P = np.random.default_rng(2).normal(scale=1.0, size=(64, 3)).astype(
    np.float32)
# tangents: rotations up to ~2 rad, and the Taylor branch (|w|² < 1e-8)
XI = np.random.default_rng(3).normal(scale=0.8, size=(64, 6)).astype(
    np.float32)
XI[:8, :3] *= 1e-5

# (name, jax fn, port fn, inputs)
CASES = [
    ("quat_normalize", jgeo.quat_normalize, geo.quat_normalize,
     (A[:, :4] * 3.0,)),
    ("quat_mul", jgeo.quat_mul, geo.quat_mul, (A[:, :4], B[:, :4])),
    ("quat_conj", jgeo.quat_conj, geo.quat_conj, (A[:, :4],)),
    ("quat_rotate", jgeo.quat_rotate, geo.quat_rotate, (A[:, :4], P)),
    ("quat_to_matrix", jgeo.quat_to_matrix, geo.quat_to_matrix,
     (A[:, :4],)),
    ("compose", jgeo.compose, geo.compose, (A, B)),
    ("inverse", jgeo.inverse, geo.inverse, (A,)),
    ("transform_points", jgeo.transform_points, geo.transform_points,
     (A, P)),
    ("transform_points_broadcast", jgeo.transform_points,
     geo.transform_points, (A[0], P)),
    ("relative", jgeo.relative, geo.relative, (A, B)),
    ("make", jgeo.make, geo.make, (A[:, :4], A[:, 4:])),
    ("rotation", jgeo.rotation, geo.rotation, (A,)),
    ("translation", jgeo.translation, geo.translation, (A,)),
    ("so3_exp", jgeo.so3_exp, geo.so3_exp, (XI[:, :3],)),
    ("so3_log", jgeo.so3_log, geo.so3_log, (A[:, :4],)),
    ("se3_exp", jgeo.se3_exp, geo.se3_exp, (XI,)),
    ("se3_log", jgeo.se3_log, geo.se3_log, (A,)),
    ("se3_log_near_identity", jgeo.se3_log, geo.se3_log,
     (np.asarray(jgeo.se3_exp(jnp.asarray(XI * 1e-5))),)),
]


@pytest.mark.parametrize("name,jfn,pfn,args", CASES,
                         ids=[c[0] for c in CASES])
def test_op_matches_jax(name, jfn, pfn, args):
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = pfn(*(_t(a) for a in args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_identity_matches_jax():
    np.testing.assert_array_equal(geo.identity(CPU).numpy(),
                                  np.asarray(jgeo.identity()))


def test_matrix_to_quat_matches_jax():
    # rotation matrices from every Shepperd branch: random, and the
    # 180° turns about each axis (trace ≤ 0, each diagonal dominant)
    R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(A[:, :4])))
    flips = np.stack([np.diag(d).astype(np.float32) for d in
                      ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    R = np.concatenate([R, flips])
    want = np.asarray(jgeo.matrix_to_quat(jnp.asarray(R)))
    got = geo.matrix_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["compose_np", "relative_np", "inverse_np",
                                  "transform_points_np"])
def test_numpy_twins_match_jax(name):
    if name == "inverse_np":
        args = (A,)
    elif name == "transform_points_np":
        args = (A[3], P)
    else:
        args = (A, B)
    np.testing.assert_allclose(getattr(geo, name)(*args),
                               getattr(jgeo, name)(*args), atol=ATOL,
                               rtol=0)


# the solve slice's additions: matrices, 4-DoF poses, interpolation and
# pose-history lookup (stamps exact, poses 1e-6)
XYZYAW = np.random.default_rng(4).normal(size=(64, 4)).astype(np.float32)
ALPHA = np.random.default_rng(5).uniform(0, 1, 64).astype(np.float32)
NEAR = A.copy()                      # nearly parallel pairs: the nlerp path
NEAR[:, :4] = np.array(jgeo.quat_normalize(jnp.asarray(
    A[:, :4] + 1e-7 * B[:, :4])))

SOLVE_CASES = [
    ("to_matrix", jgeo.to_matrix, geo.to_matrix, (A,)),
    ("from_matrix", jgeo.from_matrix, geo.from_matrix,
     (np.array(jgeo.to_matrix(jnp.asarray(A))),)),
    ("from_xyzyaw", jgeo.from_xyzyaw, geo.from_xyzyaw, (XYZYAW,)),
    ("to_xyzyaw", jgeo.to_xyzyaw, geo.to_xyzyaw, (A,)),
    ("interpolate", jgeo.interpolate, geo.interpolate, (A, B, ALPHA)),
    ("interpolate_near", jgeo.interpolate, geo.interpolate,
     (A, NEAR, ALPHA)),
]


@pytest.mark.parametrize("name,jfn,pfn,args", SOLVE_CASES,
                         ids=[c[0] for c in SOLVE_CASES])
def test_solve_op_matches_jax(name, jfn, pfn, args):
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = pfn(*(_t(a) for a in args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


STAMPS = np.cumsum(np.random.default_rng(6).uniform(0.05, 0.2, 64)).astype(
    np.float32)
# before the first stamp, on stamps, between them and past the last
TIMES = np.concatenate([[STAMPS[0] - 1.0], STAMPS[[0, 5, 63]],
                        0.5 * (STAMPS[10:13] + STAMPS[11:14]),
                        [STAMPS[-1] + 2.0]]).astype(np.float32)


@pytest.mark.parametrize("t", list(TIMES), ids=range(len(TIMES)))
def test_lookup_pose_matches_jax(t):
    want = np.asarray(jgeo.lookup_pose(jnp.asarray(STAMPS), jnp.asarray(A),
                                       jnp.asarray(t)))
    got = geo.lookup_pose(_t(STAMPS), _t(A), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(geo.lookup_pose_np(STAMPS, A, float(t)),
                               jgeo.lookup_pose_np(STAMPS, A, float(t)),
                               atol=ATOL, rtol=0)


def test_identity_np_matches_jax():
    for dtype in (None, np.float64):
        a, b = geo.identity_np(dtype), jgeo.identity_np(dtype)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
