"""The port's real-sequence path — eval.demos.tum_pipeline,
drifted_odometry, the operating points of the drift tests, the loop
detector on real texture and the server's intra-client route — against
the JAX package's tests/test_tum_replay.py and tests/test_real_replay.py
flows, on the CPU at cuts of those flows.

Tolerances:
* the ground truth as TumRgbdReplay.groundtruth reads it: equal to the
  JAX test's read_groundtruth.
* tum_pipeline on tum_tiny: the submap count equal, the trajectory's
  stamps within 1e-6 s and poses within 1e-5 of JAX's, the submaps'
  layers with equal blocks and TSDF within 1e-5 m, weights and colours
  within 1e-4 (f32 integration order; 4.8e-6, 1.4e-5 and 5.1e-5
  observed), the port's extractor and metric on JAX's merged layer with
  JAX's triangle count and q90 within 1e-5 m, and the JAX test's gates
  on both. The two merged layers themselves differ: the clip's first
  pose is an exact 90° turn with its translation on the 0.1 m lattice,
  so the merge's trilinear samples fall on voxel centres, and the last
  f32 bit of each package's sample coordinate picks the corners
  (ROADMAP parity notes). The whole flow's mesh is therefore held to a
  vertex count within 1.5% of JAX's and a q90 within 2.5 mm (51,426
  against 51,942 vertices, 1.044 against 1.231 cm observed).
* drifted_odometry against the JAX tests' recipe, both clips' 144 poses:
  within 1e-6 (the same f32 numpy chain; only se3_exp differs, torch's
  f32 against XLA's; 7.5e-7 observed).
* the operating-point configs through utils.interop: equal.
* keyframe selection on both clips: the same count and the same stamps.
* detection on 4 tum_real frames at K = 512: the same keypoints (valid
  flags, pixels, responses within 1e-5 of the frame's peak, camera points
  within 1e-5 m), descriptors equal but for the convolution-order flips
  (ROADMAP parity notes), each at a BRIEF pair whose two blurred
  intensities in JAX lie within 2 ulps, and at most one flip per 16 valid
  descriptors (observed 5 over 192: the photos' 8-bit values tie in the
  blur far more often than the analytic scene's ~1 per 1,024).
* closures on every 8th tum_real frame at its detector (the pool cut to
  24 slots, 8 a match step), JAX's RANSAC indices fed in: the same
  (from, to) pairs, T_from_to within 1e-5 (m, quaternion components;
  7.2e-7 observed over 5 closures).
* without a card and without a device, both flows raise.
* the intra-client route over the first 48 frames of tum_loop at its
  drift: the same routed flags, pose histories with stamps within 1e-6 s
  and poses within 1e-5 of JAX's (m, quaternion components: an LM solve
  in f32 on both sides after every routed closure; 7.2e-7 observed).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_tum_replay as ttr
from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.core import voxel as jvx
from coxgraph_tpu.eval import metrics as jmetrics
from coxgraph_tpu.frontends import loop_detector as jld
from coxgraph_tpu.frontends import replay as jreplay
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.mapper import submap_mapper as jsm
from coxgraph_tpu.ops import features as jft
from coxgraph_tpu.ops import mesh as jmesh
from coxgraph_tpu.ops import tsdf as jtsdf
from coxgraph_tpu.server import fusion_server as jfs
from coxgraph_tpu.server.client_interface import \
    InProcessClient as JInProcessClient
from coxgraph_tpu.solver import pose_graph as jpg
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.eval import demos
from coxgraph_tpu_torch.frontends import loop_detector as ld
from coxgraph_tpu_torch.frontends import replay
from coxgraph_tpu_torch.frontends import synthetic as syn
from coxgraph_tpu_torch.mapper import submap_mapper as sm
from coxgraph_tpu_torch.ops import features as ft
from coxgraph_tpu_torch.ops import mesh as mesh_ops
from coxgraph_tpu_torch.server.fusion_server import MapFusionMsg
from coxgraph_tpu_torch.utils import interop
from test_torch_mesh import one_thread  # noqa: F401

CPU = torch.device("cpu")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
JINTR = jsyn.PinholeIntrinsics().scaled(0.25)                 # 160x120
JSPEC = jvx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                          max_blocks=1024, truncation=0.3)


def _jax_points():
    """The JAX tests' operating points, as their bodies build them:
    (MapperConfig, LoopDetectorConfig, (yaw, forward) bias) of
    test_tum_replay.py:125-133, 160-166, 140-152 and test_real_replay.py:
    63-74, 107-112, 80-92."""
    def mapper(**kw):
        return jsm.MapperConfig(
            spec=JSPEC,
            integrator=jtsdf.TsdfIntegratorConfig(max_touched_blocks=512),
            intrinsics=JINTR, max_submaps=20, max_history=48,
            submap_interval=1.0, height_prior_stddev=0.1, **kw)

    return {
        "tum_loop": (mapper(), jld.LoopDetectorConfig(
            features=jft.FeatureConfig(max_keypoints=384),
            min_match_score=25, min_inliers=15, keyframe_stride=0.4,
            min_time_separation=5.0, sqrt_info=100.0), (0.0045, 0.0045)),
        "tum_real": (mapper(local_solver=jpg.SolverConfig(huber_delta=1.5)),
                     jld.LoopDetectorConfig(
            features=jft.FeatureConfig(max_keypoints=512),
            min_match_score=16, min_inliers=10, min_inlier_spread=0.4,
            max_candidates=3, keyframe_stride=0.1, min_time_separation=4.0,
            sqrt_info=100.0), (0.009, 0.009)),
    }


def _jax_drifted(gt, yaw, fwd):
    """The JAX tests' drift loop, verbatim but for its inputs."""
    rng = np.random.default_rng(11)
    gt = [np.asarray(T, np.float32) for T in gt]
    drifted = [gt[0]]
    for k in range(1, len(gt)):
        T_rel = jgeo.relative_np(gt[k - 1], gt[k])
        noise = rng.normal(0, 0.0015, 6).astype(np.float32)
        noise[2] += yaw
        noise[3] += fwd
        T_rel = jgeo.compose_np(
            T_rel, np.asarray(jgeo.se3_exp(jnp.asarray(noise))))
        drifted.append(jgeo.compose_np(drifted[-1], T_rel))
    return np.stack(drifted)


def _associations(name, **kw):
    return replay.TumRgbdReplay(os.path.join(FIXTURES, name),
                                device=CPU, **kw).associations()


@pytest.fixture(scope="module")
def real_frames():
    """Every 8th tum_real frame, decoded once: [(t, depth, colour)]."""
    rp = replay.TumRgbdReplay(os.path.join(FIXTURES, "tum_real"),
                              device=CPU)
    return [(f.t, f.depth, f.color) for i, f in enumerate(rp) if i % 8 == 0]


def test_tum_pipeline_matches_jax():
    """test_tum_replay_full_pipeline's flow in JAX against the port's
    tum_pipeline on the CPU."""
    rp = jreplay.TumRgbdReplay(ttr.ROOT, intr=ttr.CFG.intrinsics)
    mapper = jsm.HostMapper(ttr.CFG)
    for f in rp:
        mapper.step(f.depth, f.color, f.T_odom_cam, f.t)
    js, jp = (np.asarray(x) for x in jsm.trajectory(mapper.state.collection))
    sg, pg = ttr.read_groundtruth(rp.t0)
    ate = jmetrics.ate_rmse(js, jp, sg, pg, max_dt=0.02)

    port_rp = replay.TumRgbdReplay(ttr.ROOT, device=CPU)
    port_rp.associations()                      # sets t0
    for g, w in zip(port_rp.groundtruth(), (sg, pg)):
        np.testing.assert_array_equal(g, w)

    got = demos.tum_pipeline(ttr.ROOT, device=CPU)
    assert interop.config_from(ttr.CFG) == demos.tum_tiny_config()
    assert got["frames"] == 10 and got["submaps"] == mapper.n_submaps >= 2
    np.testing.assert_allclose(got["stamps"], js, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["poses"], jp, atol=1e-5, rtol=0)
    assert ate < 5e-3 and got["ate"] < 5e-3, (ate, got["ate"])
    assert got["vertices"] > 300 and got["surf_q90"] < 0.3, got
    assert got["ok"]
    # the submaps the mapper built
    want_col = interop.flatten(mapper.state.collection)
    got_col = interop.flatten(got["mapper"].state.collection)
    for key in ("layers.block_coords", "layers.num_blocks"):
        np.testing.assert_array_equal(got_col[key].numpy(),
                                      np.asarray(want_col[key]))
    for key, tol in (("layers.sdf", 1e-5), ("layers.weight", 1e-4),
                     ("layers.color", 1e-4)):
        np.testing.assert_allclose(got_col[key].numpy(),
                                   np.asarray(want_col[key]), atol=tol,
                                   rtol=0, err_msg=key)
    # JAX's mesh and surface metric, and the port's on JAX's merged layer
    merged = jsm.merged_layer(ttr.CFG, mapper.state.collection)
    verts, _ = jmesh.extract_mesh(ttr.SPEC, merged, min_weight=0.1)
    sdf = np.asarray(jsyn.scene_sdf(jsyn.default_scene(),
                                    jnp.asarray(verts.reshape(-1, 3))))
    q90 = float(np.quantile(np.abs(sdf), 0.9))
    pverts, _ = mesh_ops.extract_mesh(
        demos.tum_tiny_config().spec, interop.layer_from_numpy(
            {k: np.asarray(v) for k, v in interop.flatten(merged).items()},
            CPU), min_weight=0.1)
    assert pverts.shape[0] == verts.shape[0]
    psdf = syn.scene_sdf(syn.default_scene(CPU), torch.from_numpy(
        np.ascontiguousarray(pverts.reshape(-1, 3)))).abs().numpy()
    assert abs(float(np.quantile(psdf, 0.9)) - q90) <= 1e-5
    # the whole flow, through each package's own merge
    n_verts = 3 * verts.shape[0]
    assert abs(got["vertices"] - n_verts) <= 0.015 * n_verts, (
        got["vertices"], n_verts)
    assert abs(got["surf_q90"] - q90) <= 2.5e-3, (got["surf_q90"], q90)


@pytest.mark.parametrize("name", ["tum_loop", "tum_real"])
def test_drifted_odometry_matches_jax_recipe(name):
    assoc = _associations(name)
    gt = np.stack([a[3] for a in assoc])
    assert gt.shape == (144, 7)
    _, _, drift = demos.REPLAY_POINTS[name]()
    want = _jax_drifted(gt, *_jax_points()[name][2])
    got = demos.drifted_odometry(gt, **drift)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    stamps = np.asarray([a[0] for a in assoc])
    gate = demos.REPLAY_GATES[name]["min_drifted"]
    assert jmetrics.ate_rmse(stamps, got, stamps, gt) > gate


@pytest.mark.parametrize("name", ["tum_loop", "tum_real"])
def test_operating_point_configs_match_jax(name):
    jcfg, jdet, (yaw, fwd) = _jax_points()[name]
    cfg, det, drift = demos.REPLAY_POINTS[name]()
    assert interop.config_from(jcfg) == cfg
    assert interop.config_from(jdet) == det
    assert drift == {"yaw_bias": yaw, "fwd_bias": fwd}


@pytest.mark.parametrize("name", ["tum_loop", "tum_real"])
def test_keyframe_selection_matches_jax(name, monkeypatch):
    """Both detectors' stride gate on the clip's rebased float64 stamps
    (detection stubbed out on both sides)."""
    _, jdet_cfg, _ = _jax_points()[name]
    _, det_cfg, _ = demos.REPLAY_POINTS[name]()
    jstamps = [f.t for f in jreplay.TumRgbdReplay(
        os.path.join(FIXTURES, name), intr=JINTR)]
    stamps = [a[0] for a in _associations(name)]
    assert stamps == jstamps and len(stamps) == 144
    monkeypatch.setattr(jft, "detect_and_describe", lambda *a: None)
    monkeypatch.setattr(ft, "detect_and_describe", lambda *a: None)
    taken = {"jax": [], "port": []}
    jdet = jld.LoopDetector(JINTR, jdet_cfg)
    det = ld.LoopDetector(interop.config_from(JINTR), det_cfg, device=CPU)
    jdet.ingest_keypoints = lambda c, t, kp, key=None: taken["jax"].append(t)
    det.ingest_keypoints = lambda c, t, kp, generator=None: \
        taken["port"].append(t)
    for t in stamps:
        jdet.add_keyframe(0, t, None, None)
        det.add_keyframe(0, t, None, None)
    assert taken["port"] == taken["jax"]
    # stamps 0.1 s apart meet a 0.1 s stride only where the float64
    # difference reaches it: tum_real keeps 87 of its 144 frames
    assert len(taken["port"]) == {"tum_loop": 29, "tum_real": 87}[name]


def _near_tie_flips(want, got, color):
    """(flipped bits of valid descriptors, those not at a near-tie): a
    flip is a near-tie where JAX's two blurred intensities of the BRIEF
    pair lie within 2 ulps."""
    smooth = np.asarray(jft._box_blur(jft._gray(jnp.asarray(color)), 2))
    H, W = smooth.shape
    x = np.bitwise_xor(np.asarray(want.desc),
                       got.desc.numpy().view(np.uint32))
    x[~np.asarray(want.valid)] = 0
    flips, far = 0, 0
    for k, word in zip(*np.nonzero(x)):
        u, v = np.asarray(want.uv)[k].astype(int)
        for b in range(32):
            if not (int(x[k, word]) >> b) & 1:
                continue
            j = 32 * word + b
            a, c = (smooth[np.clip(v + p[j, 1], 0, H - 1),
                           np.clip(u + p[j, 0], 0, W - 1)]
                    for p in (jft._PATTERN_A, jft._PATTERN_B))
            flips += 1
            far += abs(a - c) > 2 * np.spacing(max(abs(a), abs(c)))
    return flips, far


def test_detection_on_real_texture_matches_jax(real_frames):
    """detect_and_describe on 4 tum_real frames (depth holes, JPEG
    artifacts). The photos' 8-bit intensities make exact ties in the 5×5
    blur common, so the convolution-order flips are more frequent than on
    the analytic scene; every flip must sit on such a tie."""
    _, jdet_cfg, _ = _jax_points()["tum_real"]
    _, det_cfg, _ = demos.REPLAY_POINTS["tum_real"]()
    n_flips, n_desc = 0, 0
    for t, depth, color in real_frames[:4]:
        assert float((depth == 0).float().mean()) > 0.001   # holes
        want = jft.detect_and_describe(JINTR, jnp.asarray(color.numpy()),
                                       jnp.asarray(depth.numpy()),
                                       jdet_cfg.features)
        got = ft.detect_and_describe(interop.config_from(JINTR), color,
                                     depth, det_cfg.features)
        w = {k: np.asarray(v) for k, v in want._asdict().items()}
        g = interop.keypoints_to_numpy(got)
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["uv"], w["uv"])
        np.testing.assert_array_equal(g["has_depth"], w["has_depth"])
        peak = np.abs(w["response"]).max()
        np.testing.assert_allclose(g["response"], w["response"], rtol=0,
                                   atol=1e-5 * peak)
        np.testing.assert_allclose(g["p_cam"], w["p_cam"], atol=1e-5, rtol=0)
        flips, far = _near_tie_flips(want, got, color.numpy())
        assert far == 0, (t, flips, far)
        n_flips += flips
        n_desc += int(w["valid"].sum())
    assert n_desc > 150 and n_flips <= n_desc // 16, (n_flips, n_desc)


def _jax_ransac_indices(det):
    """The draws JAX's detector makes, for the port's ransac_indices
    (loop_detector.py:330 keys the ingest by total_keyframes·97,
    _match_and_verify splits the key over the candidates, ransac_rigid
    draws ∝ validity, features.py:269-272)."""
    @functools.partial(jax.jit, static_argnums=2)
    def draw(key, valid, iters):
        probs = valid.astype(jnp.float32) / jnp.maximum(valid.sum(), 1)
        return jax.random.choice(key, valid.shape[0], shape=(iters, 3),
                                 p=probs)

    def indices(valid, iters, generator=None):
        v = valid.reshape(-1, valid.shape[-1]).numpy()
        keys = jax.random.split(jax.random.PRNGKey(det.total_keyframes * 97),
                                v.shape[0])
        out = np.stack([np.asarray(draw(k, jnp.asarray(vv), iters))
                        for k, vv in zip(keys, v)])
        return torch.from_numpy(out.astype(np.int64)).reshape(
            *valid.shape[:-1], iters, 3)
    return indices


def test_closures_on_real_texture_match_jax(real_frames, monkeypatch):
    """The tum_real detector on every 8th frame (18 keyframes, 0.8 s
    apart) in both packages: the same closures."""
    _, jdet_cfg, _ = _jax_points()["tum_real"]
    jdet_cfg = dataclasses.replace(jdet_cfg, max_keyframes=24, match_chunk=8)
    jdet = jld.LoopDetector(JINTR, jdet_cfg)
    det = ld.LoopDetector(interop.config_from(JINTR),
                          interop.config_from(jdet_cfg), device=CPU)
    monkeypatch.setattr(ft, "ransac_indices", _jax_ransac_indices(det))
    want, got = [], []
    for t, depth, color in real_frames:
        want += jdet.add_keyframe(0, t, jnp.asarray(color.numpy()),
                                  jnp.asarray(depth.numpy()))
        got += det.add_keyframe(0, t, color, depth)
    assert det.total_keyframes == jdet.total_keyframes == 18
    pairs = [[(m.from_time, m.to_time) for m in msgs] for msgs in (got,
                                                                   want)]
    assert pairs[0] == pairs[1] and len(pairs[0]) >= 3, pairs
    for g, w in zip(got, want):
        assert (g.from_client, g.to_client) == (0, 0)
        np.testing.assert_allclose(g.T_from_to, np.asarray(w.T_from_to),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(g.sqrt_info, np.asarray(w.sqrt_info))


def _closures(gt, stamps, intervals):
    """Ground-truth closures over the first 48 frames: three across
    submaps, one inside a submap, one at a time between two submaps'
    intervals and one past the last frame — the last three are not
    routed."""
    out = []
    for a, b in ((2, 45), (5, 33), (22, 47), (13, 17)):
        T = geo.relative_np(gt[a], gt[b]).astype(np.float32)
        out.append((stamps[a], stamps[b], T))
    gap = 0.5 * (intervals[1][1] + intervals[2][0])
    out.append((stamps[3], gap, out[0][2]))
    out.append((stamps[4], stamps[-1] + 5.0, out[0][2]))
    return out


def test_intra_client_route_matches_jax():
    """The first 48 tum_loop frames at the clip's drift, mapped by both
    packages, then the same closures through both servers' map_fusion."""
    name, n = "tum_loop", 48
    jcfg, _, (yaw, fwd) = _jax_points()[name]
    cfg, _, drift = demos.REPLAY_POINTS[name]()
    rp = replay.TumRgbdReplay(os.path.join(FIXTURES, name),
                              intr=cfg.intrinsics, max_frames=n, device=CPU)
    assoc = rp.associations()
    stamps = [a[0] for a in assoc]
    gt = np.stack([a[3] for a in assoc])
    drifted = demos.drifted_odometry(gt, **drift)
    si = 100.0 * np.eye(6, dtype=np.float32)

    mapper, _, _, st = demos.map_drifted(rp, drifted, cfg, None, CPU)
    assert st["frames"] == n and mapper.n_submaps == 5
    closures = _closures(gt, stamps, [(r["start"], r["end"])
                                      for r in mapper.host_submaps])
    client, flags, rt = demos.route_closures(
        cfg, mapper, [MapFusionMsg(0, ta, 0, tb, T, si)
                      for ta, tb, T in closures], CPU)
    assert rt["mirror_err"] == 0.0

    jmapper = jsm.HostMapper(jcfg)
    for f, T in zip(rp, drifted):
        jmapper.step(jnp.asarray(f.depth.numpy()),
                     jnp.asarray(f.color.numpy()), jnp.asarray(T), f.t)
    jclient = JInProcessClient(0, jcfg, jmapper.state)
    jserver = jfs.CoxgraphServer(
        jfs.ServerConfig(spec=JSPEC, refuse_interval=0.0), [jclient])
    jflags = [bool(jserver.map_fusion(jfs.MapFusionMsg(
        0, ta, 0, tb, T, si))) for ta, tb, T in closures]
    assert flags == jflags == [True] * 3 + [False] * 3, (flags, jflags)

    s, p = client.get_pose_history()
    js, jp = (np.asarray(x) for x in jclient.get_pose_history())
    np.testing.assert_allclose(s, js, atol=1e-6, rtol=0)
    np.testing.assert_allclose(p, jp, atol=1e-5, rtol=0)
    # the device path of the port's history agrees with its mirror
    ds, dp = (x.numpy() for x in sm.trajectory(mapper.state.collection))
    np.testing.assert_allclose(ds, s, atol=1e-6, rtol=0)
    np.testing.assert_allclose(dp, p, atol=1e-6, rtol=0)


@pytest.mark.parametrize("flow", ["tum_pipeline", "drift_correction"])
def test_flows_need_a_device_or_the_card(flow, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = os.path.join(FIXTURES, "tum_loop")
    run = {"tum_pipeline": lambda: demos.tum_pipeline(root),
           "drift_correction": lambda: demos.drift_correction(
               root, "tum_loop")}[flow]
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
