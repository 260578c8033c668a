"""coxgraph_tpu_torch.ops.features and ops.cuda_hamming vs the JAX
package's features and Pallas Hamming kernel, on the CPU (where the
port's Hamming entry points run their plain torch versions).

Tolerances:
* Hamming outputs (d1, i1, d2, the column argmin) and match indices:
  exact — integers, with JAX's tie rules.
* harris_response: rtol 1e-5 plus an atol of 1e-5 × the frame's peak
  |response| — the filters sum their taps in another order than XLA's
  convolution (observed max |Δ| 1.7e-10 against a peak of 2.7e-4; the
  relative error of values near zero is unbounded, so the peak sets the
  scale).
* detect_and_describe over 8 frames at 320×240, K = 128: valid keypoint
  sets overlap ≥ 98%, descriptors bit-equal on ≥ 99.9% of the common
  keypoints, p_cam within 1e-5. Observed: identical keypoint sets (1024
  of 1024), 1 of 1024 descriptors differing in 1 bit (a BRIEF pair whose
  two blurred intensities differ in the last bit between the summation
  orders), p_cam |Δ| 0.
* ransac_rigid fed JAX's own jax.random.choice indices: equal n_inliers
  and inlier mask, T within 1e-4 (observed 1.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.ops import features as jft
from coxgraph_tpu.ops import pallas_kernels as pk
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.ops import cuda_hamming
from coxgraph_tpu_torch.ops import features as ft
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
JINTR = jsyn.PinholeIntrinsics().scaled(0.5)              # 320x240
INTR = interop.config_from(JINTR)
JCFG = jft.FeatureConfig(max_keypoints=128, ransac_iters=64)
CFG = interop.config_from(JCFG)


def _desc(rng, *shape):
    """uint32 descriptor words (numpy) and their int32 bit patterns."""
    d = rng.integers(0, 2 ** 32, size=(*shape, 8), dtype=np.uint64) \
        .astype(np.uint32)
    return d, torch.from_numpy(d.view(np.int32).copy())


def _frames(n, sweep=2 * np.pi):
    scene = jsyn.default_scene()
    traj = np.asarray(jsyn.orbit_trajectory(n, scene.room_center,
                                            radius=2.5, sweep=sweep))
    fr = [jsyn.render_depth(scene, JINTR, traj[i]) for i in range(n)]
    return ([np.asarray(f[1]) for f in fr], [np.asarray(f[0]) for f in fr],
            traj)


@pytest.mark.parametrize("ka,kb,seed", [(128, 96, 0), (384, 200, 2),
                                        (128, None, 4)])
def test_hamming_topk_matches_pallas(ka, kb, seed):
    """The port's K2 entry point ≡ the Pallas kernel (interpret mode) and
    its jnp reference, on tests/test_pallas_kernels.py's shapes (kb None:
    self-match)."""
    rng = np.random.default_rng(seed)
    da, ta = _desc(rng, ka)
    db, tb = (da, ta) if kb is None else _desc(rng, kb)
    got = [x.numpy() for x in cuda_hamming.hamming_match_topk(ta, tb)]
    pal = pk.hamming_match_topk(jnp.asarray(da), jnp.asarray(db),
                                interpret=True)
    ref = pk.hamming_match_topk_reference(jnp.asarray(da), jnp.asarray(db))
    for g, p, r, name in zip(got, pal, ref, ("d1", "i1", "d2")):
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, np.asarray(p), err_msg=name)
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)
    if kb is None:
        np.testing.assert_array_equal(got[0], 0)
        np.testing.assert_array_equal(got[1], np.arange(ka))


def _jax_match_parts(da, va, db, vb):
    """match_descriptors' intermediates (features.py:223-231) in JAX."""
    D = jft.hamming_matrix(jnp.asarray(da), jnp.asarray(db))
    BIG = jnp.int32(10_000)
    D = jnp.where(jnp.asarray(va)[:, None] & jnp.asarray(vb)[None, :], D,
                  BIG)
    best_b = jnp.argmin(D, axis=1)
    d1 = jnp.min(D, axis=1)
    d2 = jnp.min(D.at[jnp.arange(D.shape[0]), best_b].set(BIG), axis=1)
    return [np.asarray(x) for x in (d1, best_b, d2, jnp.argmin(D, axis=0))]


@pytest.mark.parametrize("shared", [True, False])
def test_match_topk_matches_match_descriptors(shared):
    """The batched masked matcher ≡ JAX match_descriptors per (query,
    database row): d1, i1, d2, the column argmin, and the final match
    indices, exactly. Rows repeat some descriptors so ties occur."""
    rng = np.random.default_rng(11 + shared)
    B, cap, K = 3, 4, 40
    da, ta = _desc(rng, B, K)
    db, tb = _desc(rng, 1 if shared else B, cap, K)
    db[..., :12, :] = da[0, None, :12] if shared else da[:, None, :12]
    db[..., 12:16, :] = db[..., 8:12, :]          # tied columns
    tb = torch.from_numpy(db.view(np.int32).copy())
    va = rng.random((B, K)) < 0.9
    vb = rng.random(db.shape[:-1]) < 0.9
    d1, i1, d2, best_a = (x.numpy() for x in cuda_hamming.match_topk(
        ta, torch.from_numpy(va), tb, torch.from_numpy(vb), 10_000, 10_000))
    idx, dist = ft.match_descriptors_batch(ta, torch.from_numpy(va), tb,
                                           torch.from_numpy(vb), CFG)
    for q in range(B):
        for j in range(cap):
            jb = 0 if shared else q
            want = _jax_match_parts(da[q], va[q], db[jb, j], vb[jb, j])
            for g, w, name in zip((d1, i1, d2, best_a), want,
                                  ("d1", "i1", "d2", "best_a")):
                np.testing.assert_array_equal(g[q, j], w,
                                              err_msg=f"{name} {q} {j}")
            ja = jft.Keypoints(None, None, jnp.asarray(va[q]),
                               jnp.asarray(da[q]), None, None)
            jb_ = jft.Keypoints(None, None, jnp.asarray(vb[jb, j]),
                                jnp.asarray(db[jb, j]), None, None)
            wi, wd = jft.match_descriptors(ja, jb_, JCFG)
            np.testing.assert_array_equal(idx[q, j].numpy(), np.asarray(wi))
            np.testing.assert_array_equal(dist[q, j].numpy(), np.asarray(wd))
    assert (idx >= 0).sum() > 0


def test_popcount_and_hamming_matrix_exact():
    x = np.array([0, 1, 3, 0xFFFFFFFF, 0x0F0F0F0F, 0x80000000], np.uint32)
    got = ft._popcount32(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), [0, 1, 2, 32, 16, 1])
    rng = np.random.default_rng(7)
    da, ta = _desc(rng, 33)
    db, tb = _desc(rng, 21)
    want = np.asarray(jft.hamming_matrix(jnp.asarray(da), jnp.asarray(db)))
    np.testing.assert_array_equal(ft.hamming_matrix(ta, tb).numpy(), want)
    np.testing.assert_array_equal(
        cuda_hamming.distances_reference(ta, tb).numpy(), want)


def test_harris_response_matches_jax():
    colors, _, _ = _frames(2, sweep=1.0)
    for c in colors:
        gray = c.mean(-1)
        want = np.asarray(jft.harris_response(jnp.asarray(gray)))
        got = ft.harris_response(torch.from_numpy(gray)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_detect_and_describe_matches_jax():
    colors, depths, _ = _frames(8)
    n_union = n_common = n_desc_equal = 0
    for c, d in zip(colors, depths):
        kj = jft.detect_and_describe(JINTR, jnp.asarray(c), jnp.asarray(d),
                                     JCFG)
        kp = ft.detect_and_describe(INTR, torch.from_numpy(c),
                                    torch.from_numpy(d), CFG)
        uj = {tuple(u): i for i, u in enumerate(np.asarray(kj.uv))
              if kj.valid[i]}
        up = {tuple(u): i for i, u in enumerate(kp.uv.numpy())
              if kp.valid[i]}
        common = set(uj) & set(up)
        n_union += len(set(uj) | set(up))
        n_common += len(common)
        dj = np.asarray(kj.desc).view(np.int32)
        for key in common:
            a, b = uj[key], up[key]
            n_desc_equal += bool((dj[a] == kp.desc[b].numpy()).all())
            np.testing.assert_allclose(kp.p_cam[b].numpy(),
                                       np.asarray(kj.p_cam[a]), atol=1e-5)
            assert bool(kp.has_depth[b]) == bool(kj.has_depth[a])
            assert float(kp.response[b]) == pytest.approx(
                float(kj.response[a]), rel=1e-5)
    assert n_common >= 0.98 * n_union, (n_common, n_union)
    assert n_desc_equal >= 0.999 * n_common, (n_desc_equal, n_common)
    assert n_common > 500


def test_detect_batch_equals_single():
    colors, depths, _ = _frames(3, sweep=1.0)
    tc = torch.from_numpy(np.stack(colors))
    td = torch.from_numpy(np.stack(depths))
    batch = ft.detect_and_describe_batch(INTR, tc, td, CFG)
    for i in range(3):
        one = ft.detect_and_describe(INTR, tc[i], td[i], CFG)
        for name, a, b in zip(ft.Keypoints._fields, batch, one):
            assert torch.equal(a[i], b), name


def _ransac_problem(seed, n=200, n_out=80):
    rng = np.random.default_rng(seed)
    pa = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    T = jgeo.se3_exp(jnp.array([0.1, -0.2, 0.3, 0.5, 0.2, -0.1]))
    pb = np.array(jgeo.transform_points(T, pa))
    pb[:n_out] += rng.normal(size=(n_out, 3)).astype(np.float32) * 2.0
    pb += rng.normal(size=pb.shape).astype(np.float32) * 0.01
    valid = rng.random(n) < 0.9
    return pa, pb, valid, np.asarray(T)


@pytest.mark.parametrize("seed", [3, 4])
def test_ransac_rigid_with_jax_indices(seed):
    pa, pb, valid, _ = _ransac_problem(seed)
    key = jax.random.PRNGKey(seed)
    want = jft.ransac_rigid(jnp.asarray(pa), jnp.asarray(pb),
                            jnp.asarray(valid), JCFG, key)
    # the draw ransac_rigid makes inside (features.py:269-272)
    probs = jnp.asarray(valid, jnp.float32) / max(int(valid.sum()), 1)
    idx = np.asarray(jax.random.choice(key, pa.shape[0],
                                       shape=(JCFG.ransac_iters, 3),
                                       p=probs))
    got = ft.ransac_rigid_from_indices(
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(valid),
        torch.from_numpy(idx), CFG)
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    np.testing.assert_allclose(got.T_b_a.numpy(), np.asarray(want.T_b_a),
                               atol=1e-4)


def test_ransac_rigid_batched_and_without_correspondences():
    """Leading batch dims run at once; a set with no valid correspondence
    draws uniformly (no raise) and keeps no inlier, as the reference."""
    probs = [_ransac_problem(s) for s in (5, 6)]
    pa = torch.from_numpy(np.stack([p[0] for p in probs]))
    pb = torch.from_numpy(np.stack([p[1] for p in probs]))
    valid = torch.from_numpy(np.stack([p[2] for p in probs]))
    valid[1] = False
    g = torch.Generator().manual_seed(0)
    res = ft.ransac_rigid(pa, pb, valid, CFG, generator=g)
    assert res.T_b_a.shape == (2, 7) and res.inlier_mask.shape == (2, 200)
    assert int(res.n_inliers[0]) > 100 and int(res.n_inliers[1]) == 0
    err = geo.se3_log(geo.relative(res.T_b_a[0],
                                   torch.from_numpy(probs[0][3])))
    assert float(torch.linalg.norm(err)) < 0.02
    idx = ft.ransac_indices(valid, 64, torch.Generator().manual_seed(1))
    assert idx.shape == (2, 64, 3)
    assert bool(valid[0][idx[0].reshape(-1)].all())


def test_estimate_relative_pose_between_views():
    """tests/test_features.py's two-view check on the port at K = 128 and
    64 RANSAC iterations (its gates: 0.06 m, 0.05 rad), with the inlier
    spread beside it."""
    scene = jsyn.default_scene()
    traj = np.asarray(jsyn.orbit_trajectory(24, scene.room_center,
                                            radius=2.5))
    kps = []
    for T in traj[:2]:
        d, c = jsyn.render_depth(scene, JINTR, T)
        kps.append(ft.detect_and_describe(
            INTR, torch.from_numpy(np.asarray(c)),
            torch.from_numpy(np.asarray(d)), CFG))
    g = torch.Generator().manual_seed(1)
    T_ab, n_inl, spread = ft.estimate_relative_pose(
        kps[0], kps[1], CFG, generator=g, return_spread=True)
    assert int(n_inl) >= CFG.min_inliers
    T_true = geo.relative(torch.from_numpy(traj[0]), torch.from_numpy(traj[1]))
    err = geo.se3_log(geo.relative(T_ab, T_true))
    assert float(torch.linalg.norm(err[3:])) < 0.06, err
    assert float(torch.linalg.norm(err[:3])) < 0.05, err
    assert 0.05 < float(spread) < 5.0
