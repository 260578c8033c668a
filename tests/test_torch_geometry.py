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
