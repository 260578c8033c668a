"""coxgraph_tpu_torch.frontends.replay against coxgraph_tpu.frontends.replay:
the port's PNG decoder ≡ PIL bit for bit on every image of the three TUM
fixtures, TumRgbdReplay frames ≡ JAX's, SyntheticReplay and
two_robot_experiment with JAX's odometry noise fed in (trajectories within
1e-6, as orbit_trajectory's parity; odometry within 1e-5;
frames at tests/test_torch_synthetic.py's render tolerances: depth within
1e-4 m on 99.9% of the pixels and < 1e-3 m everywhere, the renderer's
known boundary — ROADMAP queue 3 — and colour within 1e-3 on 99% of
them), time_shifted and OdometryTransformer exact."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from coxgraph_tpu.frontends import replay as jreplay
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu_torch.frontends import replay
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
INTR = jsyn.PinholeIntrinsics().scaled(0.125)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_noise(key, n, rot_std, trans_std):
    """The noise jax's noisy_odometry draws (its own key schedule)."""
    keys = jax.random.split(key, n - 1)
    return np.asarray(jax.vmap(lambda k: jnp.concatenate([
        jax.random.normal(k, (3,)) * rot_std,
        jax.random.normal(jax.random.fold_in(k, 1), (3,)) * trans_std]))(
            keys))


@pytest.mark.parametrize("name", ["tum_tiny", "tum_loop", "tum_real"])
def test_png_decoder_is_pil_bit_for_bit(name):
    paths = sorted(glob.glob(os.path.join(FIXTURES, name, "*", "*.png")))
    assert len(paths) >= 20
    kinds = set()
    for p in paths:
        want = np.asarray(Image.open(p))
        got = replay.read_png(p)
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=p)
        kinds.add((got.dtype.name, got.ndim))
    assert kinds == {("uint8", 3), ("uint16", 2)}


def test_png_decoder_rejects_what_it_cannot_read(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        replay.read_png(str(bad))


@pytest.mark.parametrize("name", ["tum_tiny", "tum_real"])
def test_tum_replay_frames_match_jax(name):
    root = os.path.join(FIXTURES, name)
    want = list(jreplay.TumRgbdReplay(root, intr=INTR, max_frames=12))
    rp = replay.TumRgbdReplay(root, intr=interop.config_from(INTR),
                              max_frames=12, device=CPU)
    got = list(rp)
    assert len(got) == len(want) >= 10
    assert rp.t0 > 1e6 and got[0].t == 0.0
    for g, w in zip(got, want):
        assert g.t == w.t
        np.testing.assert_array_equal(g.depth.numpy(), np.asarray(w.depth))
        np.testing.assert_array_equal(g.color.numpy(), np.asarray(w.color))
        np.testing.assert_array_equal(g.T_world_cam,
                                      np.asarray(w.T_world_cam))
        np.testing.assert_array_equal(g.T_odom_cam, np.asarray(w.T_odom_cam))


def test_tum_replay_needs_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(replay.TumRgbdReplay(os.path.join(FIXTURES, "tum_tiny"))))


def _assert_frames_close(got, want):
    for g, w in zip(got, want):
        assert abs(g.t - w.t) < 1e-12
        np.testing.assert_allclose(g.T_world_cam, np.asarray(w.T_world_cam),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.T_odom_cam, np.asarray(w.T_odom_cam),
                                   atol=1e-5, rtol=0)
        dd = np.abs(g.depth.numpy() - np.asarray(w.depth))
        assert dd.max() < 1e-3 and (dd <= 1e-4).mean() >= 0.999, \
            (dd.max(), (dd <= 1e-4).mean())
        cd = np.abs(g.color.numpy() - np.asarray(w.color)).max(axis=-1)
        assert (cd <= 1e-3).mean() >= 0.99, (cd <= 1e-3).mean()


@pytest.mark.parametrize("drift", [False, True])
def test_two_robot_experiment_matches_jax(drift):
    """The CVG two-client experiment at 80×60 and 8 frames, with JAX's
    odometry noise fed in where it drifts; the second robot's replay
    time-shifted by 10 s as well."""
    n = 8
    jreps, jtrajs, jX = jreplay.two_robot_experiment(n_frames=n, intr=INTR,
                                                     dt=0.1, drift=drift)
    reps, trajs, X = replay.two_robot_experiment(
        n_frames=n, intr=interop.config_from(INTR), dt=0.1, drift=drift,
        device=CPU)
    for r in range(2):
        np.testing.assert_allclose(trajs[r], np.asarray(jtrajs[r]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(X[r], np.asarray(jX[r]), atol=1e-7,
                                   rtol=0)
        rep = reps[r]
        assert (rep.odom_rot_std > 0) == drift and rep.seed == r
        if drift:
            rep.odometry_noise = _jax_noise(jax.random.PRNGKey(r), n,
                                            rep.odom_rot_std,
                                            rep.odom_trans_std)
        got, want = list(rep), list(jreps[r])
        assert len(got) == len(want) == n
        _assert_frames_close(got, want)
        if r == 1:
            _assert_frames_close(replay.time_shifted(got, 10.0),
                                 jreplay.time_shifted(want, 10.0))


def test_synthetic_replay_draws_its_own_noise():
    scene = syn.default_scene(CPU)
    traj = syn.orbit_trajectory(6, scene.room_center, radius=2.4).numpy()
    rp = replay.SyntheticReplay(scene, syn.PinholeIntrinsics().scaled(0.05),
                                traj, odom_rot_std=0.01,
                                odom_trans_std=0.02, seed=3)
    a, b = rp.odometry(), rp.odometry()
    np.testing.assert_array_equal(a, b)
    assert 0 < np.abs(a - traj).max() < 0.5
    np.testing.assert_array_equal(a[0], traj[0])
    frames = list(rp)
    np.testing.assert_array_equal(np.stack([f.T_odom_cam for f in frames]),
                                  a)
    assert all(f.depth.shape == (24, 32) for f in frames)


def test_odometry_transformer_matches_jax():
    from coxgraph_tpu.core import geometry as jgeo

    kw = dict(origin_xyz=(1.0, -2.0, 0.5), origin_yaw=0.7,
              odom_frame="odom_0", base_frame="base_0")
    jot, ot = jreplay.OdometryTransformer(**kw), replay.OdometryTransformer(
        **kw)
    assert ot.frames() == {}
    np.testing.assert_array_equal(ot.T_G_O, jot.T_G_O)
    T_G_B = np.asarray(jgeo.from_xyzyaw(jnp.array([3.0, 1.0, 2.0, 1.2])))
    lin, ang = np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.5])
    for g, w in zip(ot.transform(T_G_B, lin, ang),
                    jot.transform(T_G_B, lin, ang)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ot.transform(torch.from_numpy(T_G_B)),
                                  jot.transform(T_G_B))
    assert set(ot.frames()) == set(jot.frames()) == {("odom_0", "base_0")}
    np.testing.assert_array_equal(
        replay.OdometryTransformer().transform(T_G_B),
        jreplay.OdometryTransformer().transform(T_G_B))
