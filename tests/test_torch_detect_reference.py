"""The port's loop detector against the benchmark's plain reference
(``slambench/reference/detect.py``), on the CPU at small sizes: the
reference is written from the detector's description, not from the
port's code, and the ``cvg_frontend.detect`` cell holds the port to it
on the card.

Tolerances: keypoint positions, validity, depth flags and descriptor bits
exact (both sides take the described filters in the described order in
float32, so no rounding tie moves a keypoint); back-projected points
within 1e-6 m; match counts, candidates and the slot table exact;
closures as pairs exact and their transforms within 1e-3 m and 1e-3 rad
(noise-free points: both RANSACs refit on every correspondence, from
their own draws); on the detector's stream of triples, RANSAC's inliers
exact and its transforms within 1e-5. The port fed bfloat16 images moves
most keypoints.
"""

import numpy as np
import pytest
import torch

from coxgraph_tpu_torch.frontends import loop_detector as ld
from coxgraph_tpu_torch.frontends.synthetic import PinholeIntrinsics
from coxgraph_tpu_torch.ops import features as ft
from slambench.reference import detect as ref
from slambench.reference import geometry as rgeo
from slambench.traffic import synthetic as syn

CPU = torch.device("cpu")
CAM = syn.Camera(80, 60, 65.625, 65.625, 39.5, 29.5)
INTR = PinholeIntrinsics(width=80, height=60, fx=65.625, fy=65.625,
                         cx=39.5, cy=29.5)
FEATURES = dict(max_keypoints=48, harris_k=0.04, nms_radius=3,
                min_response=0.01, border=6, match_max_hamming=64,
                match_ratio=0.9, ransac_iters=32, ransac_inlier_dist=0.1,
                ransac_refine_frac=0.5, depth_edge_rel=0.04)
DETECTOR = dict(max_keyframes=16, min_match_score=10, min_inliers=8,
                min_time_separation=3.0, max_candidates=2,
                min_inlier_spread=0.3)
NOISE = {"sigma_a": 0.0012, "sigma_b": 0.0019, "sigma_z0": 0.4,
         "grazing_cos": 0.12, "speckle_holes": 0.003, "factor": 5000.0}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params() -> ref.Params:
    return ref.Params.of(dict(DETECTOR, features=FEATURES))


def _port_config() -> ld.LoopDetectorConfig:
    return ld.LoopDetectorConfig(features=ft.FeatureConfig(**FEATURES),
                                 keyframe_stride=0.0, match_chunk=4,
                                 **DETECTOR)


@pytest.fixture(scope="module")
def frames():
    """Three 80x60 views of the benchmark's room with the Kinect model."""
    scene = syn.default_room(CPU)
    centre = scene.room_center.numpy().astype(np.float64)
    poses = syn.orbit(3, centre, 2.4, 0.0, 0.7, sweep=0.3)
    g = torch.Generator().manual_seed(11)
    depth, c8 = syn.render_lap(scene, CAM, poses, g, NOISE, CPU)
    return syn.colour_f32(c8), depth


def test_features_equal_the_reference(frames):
    color, depth = frames
    p = _params()
    got = ft.detect_and_describe_batch(INTR, color, depth,
                                       ft.FeatureConfig(**FEATURES))
    want = ref.features(CAM, color, depth, p)
    assert int(want.valid.sum()) > 40 and int(want.has_depth.sum()) > 10
    assert torch.equal(got.uv, want.uv)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.has_depth, want.has_depth)
    assert torch.equal(got.desc, want.desc)
    assert torch.allclose(got.p_cam, want.p_cam, rtol=0.0, atol=1e-6)


def test_bfloat16_images_fail_the_tolerance(frames):
    """The port's CPU path fed bfloat16 images: keypoints move and
    descriptor bits change, on more rows than the cell's limit on
    mismatched pool rows (0.05) allows."""
    color, depth = frames
    got = ft.detect_and_describe_batch(
        INTR, color.to(torch.bfloat16), depth.to(torch.bfloat16),
        ft.FeatureConfig(**FEATURES))
    want = ref.features(CAM, color, depth, _params())
    assert not torch.equal(got.uv.to(torch.float32), want.uv)
    bad = ((got.uv.to(torch.float32) != want.uv).any(-1)
           | (got.desc != want.desc).any(-1) | (got.valid != want.valid))
    assert float(bad.float().mean()) > 0.05


def _noisy_copies(g, base, n, flip):
    """n copies of descriptor words ``base`` (K, 8) int32, each bit flipped
    with probability ``flip``."""
    bits = torch.rand((n, *base.shape, 32), generator=g) < flip
    mask = (bits.to(torch.int64) << torch.arange(32)).sum(-1)
    mask = torch.where(mask >= 2 ** 31, mask - 2 ** 32, mask)
    return base[None] ^ mask.to(torch.int32)


def test_match_counts_and_candidates_equal():
    """K = 64 seeded descriptors against a 16-slot pool of noisy copies of
    the queries (more bits flipped slot by slot): counts as integers and
    the top two eligible slots."""
    g = torch.Generator().manual_seed(3)
    K, cap = 64, 16
    q = torch.randint(-2 ** 31, 2 ** 31, (2, K, 8), dtype=torch.int32,
                      generator=g)
    pool = torch.cat([_noisy_copies(g, q[s % 2], 1, 0.01 + 0.02 * (s % 8))
                      for s in range(cap)])
    q_valid = torch.rand(2, K, generator=g) < 0.9
    pool_valid = torch.rand(cap, K, generator=g) < 0.9
    p = _params()
    cfg = ft.FeatureConfig(**dict(FEATURES, max_keypoints=K))
    got = ld._count_matches(pool, pool_valid, q, q_valid, cfg, 4)
    want = ref.scores(ref.Features(None, q_valid, q, None, None), pool,
                      pool_valid, p, chunk=4)
    assert torch.equal(got.to(torch.int64), want)
    assert int(want.max()) > 20 and len(set(want.flatten().tolist())) > 8
    elig = torch.rand(2, cap, generator=g) < 0.7
    pcam = torch.rand(cap, K, 3, generator=g) + 1.0
    kps = ft.Keypoints(None, None, q_valid, q, torch.rand(2, K, 3) + 1.0,
                       q_valid)
    scores, slots, *_ = ld._match_and_verify_batch(
        pool, pool_valid, pcam, pool_valid, elig, kps, cfg, 2, 4,
        torch.Generator().manual_seed(0))
    want_s, want_slots = ref.candidates(want, elig, 2)
    assert torch.equal(scores.to(torch.int64), want_s)
    assert torch.equal(slots, want_slots)


def _keypoints(K, pts, desc, T=None):
    """Keypoints of points ``pts`` (K, 3) seen through T (7,) (identity:
    None), all valid with depth."""
    if T is not None:
        pts = rgeo.transform_points(T, pts)
    return ft.Keypoints(uv=None, response=None,
                        valid=torch.ones(K, dtype=torch.bool), desc=desc,
                        p_cam=pts.to(torch.float32),
                        has_depth=torch.ones(K, dtype=torch.bool))


def test_slot_table_after_more_ingests_than_slots():
    """40 ingests from three robots, unevenly, into 16 slots, singly and
    by sub-batches of 4: the port's table equals the reference's after
    every step."""
    g = torch.Generator().manual_seed(9)
    det = ld.LoopDetector(INTR, _port_config(), device=CPU)
    table = ref.SlotTable(16)
    rng = np.random.default_rng(4)
    clients = rng.choice(3, size=40, p=[0.5, 0.3, 0.2])
    K = FEATURES["max_keypoints"]

    def kp(n):
        return ft.Keypoints(
            uv=None, response=None,
            valid=torch.ones(n, K, dtype=torch.bool),
            desc=torch.randint(-2 ** 31, 2 ** 31, (n, K, 8),
                               dtype=torch.int32, generator=g),
            p_cam=torch.rand(n, K, 3, generator=g) + 1.0,
            has_depth=torch.ones(n, K, dtype=torch.bool))

    i = 0
    while i < len(clients):
        if i < 20:
            c, t = int(clients[i]), float(i)
            k = kp(1)
            det.ingest_keypoints(c, t, ft.Keypoints(*(
                None if f is None else f[0] for f in k)))
            table.store(c, t, i)
            i += 1
        else:
            meta = [(int(clients[j]), float(j)) for j in range(i, i + 4)]
            det._ingest_keypoints_batch(meta, kp(4), None)
            for c, t in meta:
                table.store(c, t, 0)
            i += 4
        port = [(-1, 0.0) if s is None else (s.client_id, s.t)
                for s in det.slots]
        assert port == list(zip(table.client.tolist(), table.t.tolist()))
    assert det.dropped_keyframes == table.evictions > 0


def test_closures_and_transforms_agree():
    """Two robots seeing one cloud of 48 points from poses a few degrees
    and decimetres apart, a keyframe every second: the port's messages
    equal the reference's closures, transforms within tolerance."""
    g = torch.Generator().manual_seed(21)
    K = FEATURES["max_keypoints"]
    pts = torch.stack([torch.rand(K, generator=g) * 4 - 2,
                       torch.rand(K, generator=g) * 3 - 1.5,
                       torch.rand(K, generator=g) * 3 + 2], -1)
    desc = torch.randint(-2 ** 31, 2 ** 31, (K, 8), dtype=torch.int32,
                         generator=g)
    det = ld.LoopDetector(INTR, _port_config(), device=CPU)
    p = _params()
    table = ref.SlotTable(p.max_keyframes)
    feats, emitted, want = {}, set(), {}
    for i in range(12):
        c, t = i % 2, float(i // 2) * 1.0 + 0.25 * (i % 2)
        w = torch.tensor([0.02 * i, -0.03 * (i % 3), 0.01 * i],
                         dtype=torch.float64)
        T = rgeo.make(rgeo.so3_exp(w), torch.tensor(
            [0.05 * i, 0.02 * (i % 4), -0.03 * i], dtype=torch.float64))
        d = _noisy_copies(g, desc, 1, 0.02)[0]
        kp = _keypoints(K, pts.to(torch.float64), d, T)
        f = ref.Features(None, kp.valid[None], kp.desc[None],
                         kp.p_cam[None], kp.has_depth[None])
        if (table.client >= 0).any():
            elig = torch.from_numpy(table.eligible(
                c, t, p.min_time_separation))[None]
            pool = [feats[int(tag)] if tag >= 0 else None
                    for tag in table.tag]
            pd = torch.stack([x.desc[0] if x is not None else
                              torch.zeros(K, 8, dtype=torch.int32)
                              for x in pool])
            pv = torch.stack([x.valid[0] if x is not None else
                              torch.zeros(K, dtype=torch.bool)
                              for x in pool])
            score = ref.scores(f, pd, pv, p, chunk=4)
            top, slots = ref.candidates(score, elig, p.max_candidates)
            for s_, sl in zip(top[0].tolist(), slots[0].tolist()):
                if s_ < 0:
                    continue
                a = feats[int(table.tag[sl])]
                Tr, inl, spr, _ = ref.verify(a, f, p,
                                             np.random.default_rng(i))
                if ref.closes(p, s_, int(inl[0]), float(spr[0])):
                    want[(int(table.client[sl]), float(table.t[sl]), c,
                          t)] = Tr[0]
        for m in det.ingest_keypoints(c, t, kp,
                                      torch.Generator().manual_seed(i)):
            key = (m.from_client, m.from_time, m.to_client, m.to_time)
            emitted.add(key)
            M = torch.from_numpy(rgeo.np_to_matrix(m.T_from_to)).float()
            assert key in want, key
            assert float((M[:3, 3] - want[key][:3, 3]).norm()) < 1e-3
            R = M[:3, :3].T @ want[key][:3, :3]
            assert float((R - torch.eye(3)).norm()) < 1e-3
        feats[i] = f
        table.store(c, t, i)
    assert emitted == set(want) and len(emitted) >= 6



def test_ransac_on_the_detectors_stream_equals_the_port():
    """With the detector's stream of triples (a generator seeded with 97 ×
    the keyframes before the sub-batch), the reference's RANSAC and the
    port's fit the same triples: on two pairs of 200 noisy correspondences
    (2 cm a coordinate, a fifth of them outliers) the inliers are equal
    and the transforms within 1e-5 m and rad; from bfloat16 points, over
    1e-4."""
    g = torch.Generator().manual_seed(5)
    M = 200
    pa = torch.stack([torch.rand(2, M, generator=g) * 4 - 2,
                      torch.rand(2, M, generator=g) * 3 - 1.5,
                      torch.rand(2, M, generator=g) * 3 + 2], -1)
    R = rgeo.quat_to_matrix(rgeo.so3_exp(torch.tensor(
        [0.1, -0.05, 0.2], dtype=torch.float64))).float()
    pb = pa @ R.T + torch.tensor([0.3, -0.1, 0.2]) \
        + 0.02 * torch.randn(2, M, 3, generator=g)
    pb[:, :40] = torch.rand(2, 40, 3, generator=g) * 4
    ok = torch.ones(2, M, dtype=torch.bool)
    ok[:, 190:] = False
    p = _params()
    res = ft.ransac_rigid(pa, pb, ok, ft.FeatureConfig(**FEATURES),
                          generator=torch.Generator().manual_seed(97 * 12))
    Rr, tr, inl = ref.ransac(pa, pb, ok, p,
                             torch.Generator().manual_seed(97 * 12))
    assert torch.equal(inl, res.inlier_mask)
    assert int(inl.sum(-1).min()) >= 140
    Tp = torch.from_numpy(rgeo.np_to_matrix(res.T_b_a.numpy()))
    c = pa.double().mean(1)
    for i in range(2):
        gap = (Tp[i, :3, :3] - Rr[i].double()) @ c[i] \
            + Tp[i, :3, 3] - tr[i].double()
        assert float(gap.norm()) < 1e-5
        assert float((Tp[i, :3, :3] - Rr[i].double()).norm()) < 1e-5
    Rb, tb, _ = ref.ransac(pa.bfloat16(), pb.bfloat16(), ok, p,
                           torch.Generator().manual_seed(97 * 12))
    assert max(float((Tp[i, :3, :3] - Rb[i].double()).norm())
               for i in range(2)) > 1e-4
