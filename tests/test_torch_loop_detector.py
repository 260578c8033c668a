"""coxgraph_tpu_torch.frontends.loop_detector vs the JAX package's loop
detector, on the CPU, and the interop that carries a detector across.

Tolerances: match scores, top slots, slot metadata, eviction order and the
(from, to) message pairs — exact; message transforms within the JAX test's
0.08 m translation gate against the ground truth (tests/test_loop_detector.py).
RANSAC draws its samples from another stream than JAX's, so transforms
and inlier counts are compared only where the verified pair is exact (a
revisit of identical keypoints: every valid point is an inlier).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coxgraph_tpu.core import geometry as jgeo
from coxgraph_tpu.frontends import loop_detector as jld
from coxgraph_tpu.frontends import synthetic as jsyn
from coxgraph_tpu.ops import features as jft
from coxgraph_tpu_torch import runtime
from coxgraph_tpu_torch.core import geometry as geo
from coxgraph_tpu_torch.frontends import loop_detector as ld
from coxgraph_tpu_torch.ops import features as ft
from coxgraph_tpu_torch.utils import interop

CPU = torch.device("cpu")
JINTR = jsyn.PinholeIntrinsics().scaled(0.5)              # 320x240
INTR = interop.config_from(JINTR)
# test_loop_detector.py's two-robot scenario at K = 128, 64 RANSAC
# iterations and a 16-slot pool (the JAX detector finds the same 6
# closures there as at K = 384)
JCFG = jld.LoopDetectorConfig(
    features=jft.FeatureConfig(max_keypoints=128, ransac_iters=64),
    min_match_score=25, min_inliers=15, keyframe_stride=0.0,
    min_time_separation=1e9, max_keyframes=16, match_chunk=8)
# test_keyframe_pool_capacity_and_eviction's detector at 16 slots
JCAP = jld.LoopDetectorConfig(
    features=jft.FeatureConfig(max_keypoints=32, ransac_iters=64),
    min_match_score=20, min_inliers=10, min_inlier_spread=0.3,
    keyframe_stride=0.0, min_time_separation=1e9, max_keyframes=16,
    match_chunk=8, max_candidates=2)


def _synthetic_kp(rng, K=32, T=None):
    """Numpy keypoints with random descriptors and well-spread 3-D points
    (test_loop_detector.py's fixture); ``T`` moves the points."""
    desc = rng.integers(0, 2 ** 32, size=(K, 8), dtype=np.uint64) \
        .astype(np.uint32)
    pts = np.stack([rng.uniform(-2, 2, K), rng.uniform(-2, 2, K),
                    rng.uniform(1.0, 3.0, K)], -1).astype(np.float32)
    if T is not None:
        pts = geo.transform_points_np(np.asarray(T), pts).astype(np.float32)
    return dict(uv=np.zeros((K, 2), np.float32),
                response=np.ones((K,), np.float32),
                valid=np.ones((K,), bool), desc=desc, p_cam=pts,
                has_depth=np.ones((K,), bool))


def _jax_kp(kp):
    return jft.Keypoints(**{k: jnp.asarray(v) for k, v in kp.items()})


def _two_robot_frames():
    scene = jsyn.default_scene()
    trajs = [np.asarray(jsyn.orbit_trajectory(
        4, scene.room_center, radius=2.5, sweep=np.pi / 2,
        start_angle=a)) for a in (0.0, -0.15)]
    frames = [[tuple(np.asarray(x) for x in jsyn.render_depth(
        scene, JINTR, T)) for T in traj] for traj in trajs]
    return trajs, frames


@pytest.fixture(scope="module")
def two_robots():
    return _two_robot_frames()


def _run(det, frames, batched, conv):
    """Robot 0's four frames, then robot 1's → [(msg, robot-1 frame)]."""
    items = [[(r, (100.0 if r else 0.0) + i, conv(c), conv(d))
              for i, (d, c) in enumerate(frames[r])] for r in (0, 1)]
    if batched:
        assert det.add_keyframes_batch(items[0]) == []
        return [(m, int(round(m.to_time - 100.0)))
                for m in det.add_keyframes_batch(items[1])]
    for it in items[0]:
        assert det.add_keyframe(*it) == []
    return [(m, i) for i, it in enumerate(items[1])
            for m in det.add_keyframe(*it)]


@pytest.mark.parametrize("batched", [False, True])
def test_two_robot_loop_detection_matches_jax(two_robots, batched):
    """add_keyframe and add_keyframes_batch on test_loop_detector.py's
    scenario: the port emits the JAX detector's (from, to) pairs, each
    within 0.08 m of the ground-truth relative pose."""
    trajs, frames = two_robots
    want = _run(jld.LoopDetector(JINTR, JCFG), frames, batched, jnp.asarray)
    det = ld.LoopDetector(INTR, interop.config_from(JCFG), device=CPU)
    got = _run(det, frames, batched, torch.from_numpy)
    pairs = [[(m.from_client, m.from_time, m.to_client, m.to_time)
              for m, _ in msgs] for msgs in (got, want)]
    assert pairs[0] == pairs[1] and len(pairs[0]) >= 4, pairs
    assert det.total_keyframes == 8
    for m, i in got:
        assert m.from_client == 0 and m.to_client == 1
        assert m.T_from_to.dtype == np.float32 and m.sqrt_info.shape == (6, 6)
        T_true = geo.relative_np(trajs[0][int(round(m.from_time))],
                                 trajs[1][i])
        err = geo.se3_log(geo.relative(torch.from_numpy(m.T_from_to),
                                       torch.from_numpy(T_true)))
        assert float(torch.linalg.norm(err[3:])) < 0.08, err


def _filled_jax_detector(rng, n=12):
    det = jld.LoopDetector(JINTR, JCAP)
    kps = [_synthetic_kp(rng) for _ in range(n)]
    for i, kp in enumerate(kps):
        det.ingest_keypoints(i % 2, float(i), _jax_kp(kp))
    return det, kps


def test_match_and_verify_on_carried_database():
    """One JAX database carried into the port: the single and batched
    match+verify passes give the JAX scores and top slots exactly, and the
    exact revisits verify with every point an inlier at the identity."""
    rng = np.random.default_rng(3)
    jdet, kps = _filled_jax_detector(rng)
    det = interop.load_detector_state(
        ld.LoopDetector(INTR, interop.config_from(JCAP), device=CPU),
        interop.detector_state_to_numpy(jdet))
    # queries: revisits of slots 3 and 8 (with a few descriptors
    # corrupted) and one unseen keyframe
    queries = [dict(kps[3]), dict(kps[8]), _synthetic_kp(rng)]
    queries[1]["desc"] = queries[1]["desc"].copy()
    queries[1]["desc"][:5] ^= np.uint32(0xFFFF)
    elig = np.stack([jdet._eligibility(2, 50.0)] * 3)   # a third robot
    elig[1, 3] = False
    jpools = (jdet._db_desc, jdet._db_valid, jdet._db_pcam, jdet._db_hdep)
    jres = [jax.device_get(jld._match_and_verify(
        *jpools, jnp.asarray(elig[b]), _jax_kp(q), JCAP.features, 2, 8,
        jax.random.PRNGKey(b))) for b, q in enumerate(queries)]
    pq = [interop.keypoints_from_numpy(q, CPU) for q in queries]
    batch = ft.Keypoints(*(torch.stack(f) for f in zip(*pq)))
    g = torch.Generator().manual_seed(0)
    got_b = ld._match_and_verify_batch(
        *det._pools(), torch.from_numpy(elig), batch, det.cfg.features, 2,
        8, g)
    for b in range(3):
        got = ld._match_and_verify(*det._pools(), torch.from_numpy(elig[b]),
                                   pq[b], det.cfg.features, 2, 8, g)
        for res in (got, tuple(x[b] for x in got_b)):
            np.testing.assert_array_equal(res[0].numpy(), jres[b][0])
            np.testing.assert_array_equal(res[1].numpy(), jres[b][1])
    assert int(got_b[0][0, 0]) == 32 and int(got_b[1][0, 0]) == 3
    assert int(got_b[0][1, 0]) == 27 and int(got_b[1][1, 0]) == 8
    for b, n_matched in ((0, 32), (1, 27)):
        assert int(got_b[3][b, 0]) == int(jres[b][3][0]) == n_matched
        np.testing.assert_allclose(got_b[2][b, 0].numpy(),
                                   [1, 0, 0, 0, 0, 0, 0], atol=1e-4)


def test_eviction_order_matches_jax():
    """test_keyframe_pool_capacity_and_eviction at 16 slots, next to the
    JAX detector: after every one of 80 ingests the slot table (client,
    time) is identical, so is every message's (from, to) pair, and the
    revisit after heavy eviction is detected by both at the identity."""
    rng = np.random.default_rng(7)
    jdet = jld.LoopDetector(JINTR, JCAP)
    det = ld.LoopDetector(INTR, interop.config_from(JCAP), device=CPU)
    n = 80
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i in range(n):
            kp = _synthetic_kp(rng)
            jm = jdet.ingest_keypoints(i % 2, float(i), _jax_kp(kp))
            pm = det.ingest_keypoints(
                i % 2, float(i), interop.keypoints_from_numpy(kp, CPU))
            assert [(m.from_client, m.from_time) for m in pm] == \
                [(m.from_client, m.from_time) for m in jm], i
            assert [None if k is None else (k.client_id, k.t)
                    for k in det.slots] == \
                [None if k is None else (k.client_id, k.t)
                 for k in jdet.slots], i
    sat = [x for x in rec if "keyframe pool saturated" in str(x.message)]
    assert len(sat) == 2                 # one per detector, at the first
    assert det.dropped_keyframes == jdet.dropped_keyframes == n - 16
    assert det.n_keyframes == 16 and det.total_keyframes == n
    per = [sum(k.client_id == c for k in det.keyframes) for c in (0, 1)]
    assert abs(per[0] - per[1]) <= 1, per
    np.testing.assert_array_equal(
        interop.detector_state_to_numpy(det)["db_desc"],
        np.asarray(jdet._db_desc))

    base = _synthetic_kp(rng)
    for d, conv in ((jdet, _jax_kp),
                    (det, lambda k: interop.keypoints_from_numpy(k, CPU))):
        d.ingest_keypoints(0, float(n), conv(base))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            msgs = d.ingest_keypoints(1, float(n + 1), conv(base))
        assert msgs and msgs[0].from_client == 0
        assert msgs[0].from_time == float(n)
        err = jgeo.se3_log(jgeo.relative(jnp.asarray(msgs[0].T_from_to),
                                         jgeo.identity()))
        assert float(jnp.linalg.norm(err)) < 0.05


@pytest.mark.parametrize("cap,n_pre", [(16, 14), (16, 20), (2, 0)],
                         ids=["reaching-capacity", "at-capacity",
                              "pool-smaller-than-sub-batch"])
def test_batched_ingest_past_capacity_matches_single_ingests(
        cap, n_pre, monkeypatch):
    """Sub-batches of 4 keyframes past capacity on the port end in the
    state the JAX detector reaches with the same keyframes ingested one by
    one: slot table, free list, counters and device pools, exactly. (The
    JAX package's own batched path evicts one slot for several members at
    capacity and raises when a sub-batch reaches capacity part-way —
    ROADMAP queue 3 — so the single path is the reference.) No append
    writes one slot twice: index_copy_ on CUDA keeps an arbitrary one of
    repeated indices."""
    append = ld._db_append_batch

    def unique_append(*args):
        slots = args[-1]
        assert slots.unique().numel() == slots.numel(), slots
        append(*args)

    monkeypatch.setattr(ld, "_db_append_batch", unique_append)
    rng = np.random.default_rng(11)
    jcfg = dataclasses.replace(JCAP, max_keyframes=cap,
                               match_chunk=min(8, cap))
    jdet = jld.LoopDetector(JINTR, jcfg)
    det = ld.LoopDetector(INTR, interop.config_from(jcfg), device=CPU)
    kps = [_synthetic_kp(rng) for _ in range(n_pre + 12)]
    meta = [(i % 2, float(i)) for i in range(len(kps))]
    pkps = [interop.keypoints_from_numpy(kp, CPU) for kp in kps]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for (c, t), kp in zip(meta, kps):
            jdet.ingest_keypoints(c, t, _jax_kp(kp))
        for (c, t), kp in zip(meta[:n_pre], pkps[:n_pre]):
            det.ingest_keypoints(c, t, kp)
        for b0 in range(n_pre, len(kps), 4):
            batch = ft.Keypoints(*(torch.stack(f)
                                   for f in zip(*pkps[b0:b0 + 4])))
            det._ingest_keypoints_batch(meta[b0:b0 + 4], batch, None)
    want = interop.detector_state_to_numpy(jdet)
    got = interop.detector_state_to_numpy(det)
    assert int(got["dropped_keyframes"]) == n_pre + 12 - cap
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_same_robot_time_gate():
    """test_loop_detector.py's same-robot gate on the port: nearly
    identical consecutive views, but min_time_separation blocks them."""
    scene = jsyn.default_scene()
    traj = np.asarray(jsyn.orbit_trajectory(3, scene.room_center,
                                            radius=2.5, sweep=0.1))
    cfg = ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=128, ransac_iters=64),
        min_match_score=10, min_inliers=10, keyframe_stride=0.0,
        min_time_separation=100.0, max_keyframes=8, match_chunk=4)
    det = ld.LoopDetector(INTR, cfg, device=CPU)
    for i in range(3):
        d, c = jsyn.render_depth(scene, JINTR, traj[i])
        assert det.add_keyframe(0, i * 1.0, torch.from_numpy(np.asarray(c)),
                                torch.from_numpy(np.asarray(d))) == []
    assert det.total_keyframes == 3


def test_keypoints_and_detector_state_round_trip():
    rng = np.random.default_rng(5)
    kp = _synthetic_kp(rng)
    back = interop.keypoints_to_numpy(interop.keypoints_from_numpy(kp, CPU))
    for k, v in kp.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jdet, _ = _filled_jax_detector(rng, n=20)        # evicts 4
    want = interop.detector_state_to_numpy(jdet)
    det = interop.load_detector_state(
        ld.LoopDetector(INTR, interop.config_from(JCAP), device=CPU), want)
    assert det.dropped_keyframes == 4 and det.n_keyframes == 16
    got = interop.detector_state_to_numpy(det)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError):
        interop.load_detector_state(
            ld.LoopDetector(INTR, ld.LoopDetectorConfig(max_keyframes=8),
                            device=CPU), want)


def test_config_from_feature_and_detector_configs():
    assert interop.config_from(JCFG) == ld.LoopDetectorConfig(
        features=ft.FeatureConfig(max_keypoints=128, ransac_iters=64),
        min_match_score=25, min_inliers=15, keyframe_stride=0.0,
        min_time_separation=1e9, max_keyframes=16, match_chunk=8)
    assert interop.config_from(jld.LoopDetectorConfig()) == \
        ld.LoopDetectorConfig()
    assert interop.config_from(jft.FeatureConfig()) == ft.FeatureConfig()


def test_loop_detector_runs_on_the_card_unless_asked(monkeypatch):
    """device=None resolves to runtime.require_cuda(): with no card that
    raises, and the CPU serves only when it is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ld.LoopDetector(INTR, interop.config_from(JCAP))
    asked = []
    monkeypatch.setattr(runtime, "require_cuda",
                        lambda: asked.append(1) or CPU)
    det = ld.LoopDetector(INTR, interop.config_from(JCAP))
    assert asked == [1] and det._db_desc.device == CPU
    assert ld.LoopDetector(INTR, interop.config_from(JCAP),
                           device="cpu").device == CPU
    assert asked == [1]
