"""coxgraph_tpu_torch.frontends.synthetic vs the JAX renderer at 80×60.

Tolerances: orbit poses atol 1e-6; render_depth hit masks agree on
≥ 99.5% of pixels; depth within 1e-4 on ≥ 99.9% of the pixels both hit,
and every common hit within the tracer's 1e-3 hit threshold (XLA fuses
multiply-adds, so a ray that reaches the threshold on the boundary can
stop one sphere-tracing step apart); colour within 1e-3 on ≥ 99% of
common hits (the checker texture flips where a hit point sits on a cell
boundary). Observed: hit masks agree on every pixel; frame 0 has 1 of
4795 common hits beyond 1e-4 in depth (9.5e-4) and in colour, frame 3
none (max |Δdepth| 9.5e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
JINTR = jsyn.PinholeIntrinsics().scaled(0.125)
INTR = interop.config_from(JINTR)


@pytest.mark.parametrize("kw", [dict(n_frames=8, radius=2.5),
                                dict(n_frames=5, radius=3.0, height=0.4,
                                     sweep=0.3 * np.pi, start_angle=0.7)],
                         ids=["full", "arc"])
def test_orbit_trajectory_matches_jax(kw):
    kw = dict(kw)
    n = kw.pop("n_frames")
    want = np.asarray(jsyn.orbit_trajectory(
        n, jsyn.default_scene().room_center, **kw))
    got = syn.orbit_trajectory(n, syn.default_scene(CPU).room_center, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_scene_sdf_matches_jax():
    p = np.random.default_rng(0).uniform(
        [-5, -4, 0], [5, 4, 3], size=(2000, 3)).astype(np.float32)
    want = np.asarray(jsyn.scene_sdf(jsyn.default_scene(), jnp.asarray(p)))
    got = syn.scene_sdf(syn.default_scene(CPU), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_scaled_intrinsics_match_jax():
    for s in (0.125, 0.5, 1.0):
        assert interop.config_from(jsyn.PinholeIntrinsics().scaled(s)) == \
            syn.PinholeIntrinsics().scaled(s)


@pytest.mark.parametrize("frame", [0, 3])
def test_render_depth_matches_jax(frame):
    traj = np.asarray(jsyn.orbit_trajectory(
        6, jsyn.default_scene().room_center, radius=2.5))
    dj, cj = jsyn.render_depth(jsyn.default_scene(), JINTR,
                               jnp.asarray(traj[frame]))
    dj, cj = np.asarray(dj), np.asarray(cj)
    dp, cp = syn.render_depth(syn.default_scene(CPU), INTR,
                              torch.from_numpy(traj[frame].copy()))
    dp, cp = dp.numpy(), cp.numpy()
    assert dp.shape == dj.shape and cp.shape == cj.shape
    hit_j, hit_p = dj > 0, dp > 0
    assert (hit_j == hit_p).mean() >= 0.995
    both = hit_j & hit_p
    assert both.mean() > 0.9
    ddiff = np.abs(dp - dj)[both]
    assert (ddiff <= 1e-4).mean() >= 0.999
    assert ddiff.max() < 1e-3
    cdiff = np.abs(cp - cj).max(axis=-1)[both]
    assert (cdiff <= 1e-3).mean() >= 0.99
