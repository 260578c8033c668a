"""Closed-loop ingest of the CVG mission's shared loop detector: both
robots' 640×480 RGB-D keyframes through ``LoopDetector.add_keyframes_batch``
in sub-batches of ``batch_size`` (half from each robot, in time order, a
keyframe every ``keyframe_period_s`` of sensor time per robot), as fast as
the detector takes them, against a pool held full: every sub-batch scores
the whole pool, evicts, and meets revisits that verify into closures.

The keyframes come from a bank of ``bank_views`` views per robot, rendered
on the card in set-up from the seed: two robots half a lap apart on one
orbit whose period (``lap_s``) is no multiple of the keyframe period, so
that no view repeats within the bank. The bank holds more views per robot
than the pool keeps, so it is cycled with sensor time advancing and no
keyframe ever meets a copy of itself. Set-up streams keyframes through the
normal ingest until the pool is full, then a few more: that is the
warm-up.

End to end: ``device_ms_per_frame`` = the card's busy time over the
window (the union of its kernels and copies under a lean trace) / the
keyframes ingested in it. The lean trace starts after set-up, as the
solve's does: its first start takes 8-12 s, more or less from run to
run, and lies outside the window it measures. The traced run times a
bare stretch first (the profiler slows later launches), then profiles a
stretch with the port's tracing on (its ``detect.*`` spans and
counters) and counts the host syncs of a third. The check replays every ingest into the plain
reference's slot table and holds the port to the reference
(``workloads/cvg_frontend.detect.json`` gives each limit and its reason):

* ``pool_rows_mismatch``: the share of keypoint rows at sampled slots of
  the final pool (validity, descriptor bits, depth flag, point) that
  differ from the reference's features of the frame its table puts there;
* ``closures_mismatch``: the share of the window's last sub-batches'
  verified candidates on which the port's closures and those the
  reference finds from the pool as it stood disagree, candidates near a
  gate counted apart;
* ``closure_transforms_apart``: over the closures both emit there, the
  share whose transforms lie more than ``TRANSFORM_TOL`` apart (m at the
  keyframe's inlier centroid, where the fit pins the translation, or rad
  between the rotations). The reference's RANSAC takes its triples from
  the detector's described stream (``ref.draws``), so both fit the same
  triples and a transform moves only where float32 rounding moves a
  correspondence across a threshold;
* ``closure_trans_gap_m``: the largest such distance (the largest angle
  is printed).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from slambench.harness import port, trace
from slambench.reference import detect as ref
from slambench.reference import geometry as geo
from slambench.traffic import synthetic as syn

# tests/tiny.py's CPU cut (see stream.TINY)
TINY = {"mix": {"bank_views": 6, "warm_batches": 1, "bare_batches": 1,
                "trace_batches": 2, "sync_batches": 1, "check_batches": 2,
                "check_slots": 8, "lap_s": 2.55},
        "config": {"detector": {"max_keyframes": 8, "match_chunk": 4,
                                "min_match_score": 6, "min_inliers": 5,
                                "min_inlier_spread": 0.1,
                                "features": {"max_keypoints": 48,
                                             "border": 6,
                                             "ransac_iters": 32}}}}

# a verified candidate whose reference inliers lie within this many of the
# inlier gate, or its spread within this many metres of the spread gate,
# is counted apart: whether it closes is not held. Both RANSACs fit the
# same triples, but a correspondence that float32 rounding moves across a
# threshold changes the inliers, and with few of them the fit and the
# spread move
GATE_INLIERS = 5
GATE_SPREAD_M = 0.05
# a descriptor point as the port stores it against the reference's: both
# compute it in float32 from the same depth
PCAM_TOL_M = 1e-5
# views rendered at once into the bank: 1,040 in ten batches
RENDER_BATCH = 104
# two transforms fitted in float32 to the same triples and inliers, in m
# at the inlier centroid and in rad
TRANSFORM_TOL = 1e-4


def detector_config(cfg: dict):
    """The port's ``LoopDetectorConfig`` of a configuration's ``detector``
    section."""
    from coxgraph_tpu_torch.frontends import loop_detector as ld
    from coxgraph_tpu_torch.ops import features as ft

    d = dict(cfg["detector"])
    return ld.LoopDetectorConfig(features=ft.FeatureConfig(**d.pop(
        "features")), **d)


def k2_ops(cfg: dict, batches: int) -> float:
    """The int8 tensor-core operations of K2's launches for ``batches``
    sub-batches against a non-empty pool: B queries × every slot (the
    scoring launches) and B × max_candidates pairs (the verification
    launch), each pair Ka × Kb distances of 512 operations (a 256-deep
    multiply-add)."""
    d = cfg["detector"]
    B, cap, K = d["batch_size"], d["max_keyframes"], \
        d["features"]["max_keypoints"]
    pairs = B * cap + B * min(d["max_candidates"], cap)
    return float(batches) * pairs * K * K * 512


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.cuda = device.type == "cuda"
        self.cam = syn.Camera.of(cfg)
        self.p = ref.Params.of(cfg["detector"])
        self.robots = cfg["clients"]
        self.B = cfg["detector"]["batch_size"]
        self.per_robot = self.B // self.robots
        self.dt = mix["keyframe_period_s"]
        self.bank = mix["bank_views"]
        self.limits = mix["limits"]
        self.log = []            # each sub-batch: [(robot, t, view)]
        self.msgs = []           # each sub-batch: the port's messages
        self.step = 0            # next keyframe index of each robot
        self.rec = None          # the traced run's record

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from coxgraph_tpu_torch.frontends import loop_detector as ld
        from coxgraph_tpu_torch.frontends.synthetic import PinholeIntrinsics

        t0 = time.perf_counter()
        port.load_kernels(self.device)
        self._inputs()
        port.fence(self.device)
        t1 = time.perf_counter()
        c = self.cfg["camera"]
        intr = PinholeIntrinsics(width=c["width"], height=c["height"],
                                 fx=c["fx"], fy=c["fy"], cx=c["cx"],
                                 cy=c["cy"])
        self.det = ld.LoopDetector(intr, detector_config(self.cfg),
                                   device=self.device)
        # the pool filled through the normal ingest, then held full for a
        # few sub-batches
        fill = -(-self.p.max_keyframes // self.B)
        self._batches(fill + self.mix["warm_batches"])
        port.fence(self.device)
        print(f"detect: set-up: the bank {t1 - t0:.3f} s, {fill} + "
              f"{self.mix['warm_batches']} sub-batches "
              f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def _inputs(self) -> None:
        """Each robot's bank of views, rendered on the card from the seed:
        depth with the Kinect model and the sensor's 8-bit colour, as
        float32 frames."""
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        scene = syn.default_room(self.device)
        centre = scene.room_center.cpu().numpy().astype(np.float64)
        o = self.mix["orbit"]
        a0 = rng.uniform(0.0, 2 * math.pi)
        sweep = 2 * math.pi * self.bank * self.dt / self.mix["lap_s"]
        self.depth, self.color = [], []
        for r in range(self.robots):
            poses = syn.orbit(self.bank, centre, o["radius"], o["height"],
                              a0 + 2 * math.pi * r / self.robots, sweep)
            d, c8 = syn.render_lap(scene, self.cam, poses, gen,
                                   self.cfg["depth_noise"], self.device,
                                   batch=RENDER_BATCH)
            self.depth.append(d)
            self.color.append(syn.colour_f32(c8))

    def _items(self, k0: int) -> list:
        """The sub-batch from each robot's keyframe ``k0``: (robot, t,
        view), in time order."""
        return [(r, (k0 + i) * self.dt, (k0 + i) % self.bank)
                for i in range(self.per_robot) for r in range(self.robots)]

    def _advance(self) -> None:
        """The next sub-batch through the detector."""
        items = self._items(self.step)
        frames = [(r, t, self.color[r][v], self.depth[r][v])
                  for r, t, v in items]
        with trace.span("add_keyframes_batch"):
            msgs = self.det.add_keyframes_batch(frames)
        self.log.append(items)
        self.msgs.append(msgs)
        self.step += self.per_robot

    def _batches(self, n: int):
        for _ in range(n):
            self._advance()

    # -- measurement -------------------------------------------------------

    def trace(self) -> dict:
        """A bare stretch timed on the host, then a profiled stretch with
        the port's tracing on and a sync-counted stretch."""
        m = self.mix
        port.fence(self.device)
        t0 = time.perf_counter()
        self._batches(m["bare_batches"])
        port.fence(self.device)
        rate = m["bare_batches"] * self.B / (time.perf_counter() - t0)
        before = port.counters()
        with port.tracing():
            rec = self.rec = trace.profile(
                lambda: self._batches(m["trace_batches"]))
        after = port.counters()
        rec["counters"] = {k: v - before.get(k, 0) for k, v in after.items()}
        rec["frames"] = m["trace_batches"] * self.B
        rec["k2_ops"] = k2_ops(self.cfg, m["trace_batches"])
        rec["frames_per_s"] = rate
        _, rec["syncs"] = trace.count_syncs(
            lambda: self._batches(m["sync_batches"]))
        rec["sync_frames"] = m["sync_batches"] * self.B
        print(f"detect: traced counters {rec['counters']}", file=sys.stderr)
        return rec

    def window(self, seconds: float) -> dict:
        """Sub-batches closed loop for ``seconds``. Untraced runs read the
        card's busy time over the whole window; the traced run's window
        runs bare."""
        j0 = len(self.log)

        def ingest():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                self._advance()

        if self.rec is None:
            r = trace.device_busy(ingest, self.cuda)
        else:
            port.fence(self.device)
            t0 = time.perf_counter()
            ingest()
            port.fence(self.device)
            r = {"window_s": time.perf_counter() - t0}
        n = (len(self.log) - j0) * self.B
        closures = sum(len(m) for m in self.msgs[j0:])
        print(f"detect: {n} keyframes, {closures} closures in "
              f"{r['window_s']!r} s", file=sys.stderr)
        if self.rec is not None:
            return {"attempted": n, "failed": 0}
        print("detect: the card busy {busy_s!r} s; the trace's start "
              "{start_s:.3f} s, stop {stop_s:.3f} s, read {read_s:.3f} s"
              .format(**r), file=sys.stderr)
        return {"device_ms_per_frame": 1e3 * r["busy_s"] / max(n, 1),
                "attempted": n, "failed": 0}

    # -- correctness -------------------------------------------------------

    def check(self, control=None) -> list:
        """The port against the reference on what the timed path left →
        [(name, value, limit)]. ``control`` (a dtype): the reference in that
        precision stands in for the port."""
        m = self.mix
        n_check = m["check_batches"]
        # every ingest replayed into the reference's slot table; the table
        # as it stood before each checked sub-batch kept
        table = ref.SlotTable(self.p.max_keyframes)
        before = []
        first = len(self.log) - n_check
        for j, items in enumerate(self.log):
            if j >= first:
                before.append(table.copy())
            for r, t, v in items:
                table.store(r, t, r * self.bank + v)
        rng = np.random.default_rng(self.seed + 1)
        slots = np.sort(rng.choice(self.p.max_keyframes, size=min(
            m["check_slots"], self.p.max_keyframes), replace=False))
        if control is None:
            rows = self._pool_rows(slots)
        self.det = None
        if self.cuda:
            torch.cuda.empty_cache()

        need = set(table.tag[slots].tolist())
        for tb in before:
            need |= set(tb.tag.tolist())
        for items in self.log[first:]:
            need |= {r * self.bank + v for r, _, v in items}
        need.discard(-1)
        feats = self._features(sorted(need), torch.float32)
        if control is not None:
            low = self._features(sorted(need), control)
            rows = self._rows(low, table.tag[slots])
        want = self._rows(feats, table.tag[slots])
        bad = ~(rows["valid"] == want["valid"])
        live = want["valid"] & rows["valid"]
        bad |= live & ((rows["desc"] != want["desc"]).any(-1)
                       | (rows["has_depth"] != want["has_depth"]))
        both = live & want["has_depth"] & rows["has_depth"]
        gap = (rows["p_cam"].to(torch.float32) - want["p_cam"]).abs() \
            .amax(-1)
        bad |= both & (gap > PCAM_TOL_M)
        rows_bad = float(bad.float().mean())
        print(f"detect: {len(slots)} slots sampled, {int(bad.sum())} of "
              f"{bad.numel()} keypoint rows mismatched", file=sys.stderr)

        ref_cl = self._closures(feats, before, torch.float32)
        if control is not None:
            got = self._closures(low, before, control)
            port_cl = {k: v["T"] for k, v in got.items() if v["closes"]}
        else:
            port_cl = {(msg.from_client, msg.from_time, msg.to_client,
                        msg.to_time): torch.from_numpy(geo.np_to_matrix(
                            msg.T_from_to)).to(self.device)
                       for msgs in self.msgs[first:] for msg in msgs}
        wrong = ties = 0
        gaps = []
        for key, r in ref_cl.items():
            near = (abs(r["inliers"] - self.p.min_inliers) <= GATE_INLIERS
                    or abs(r["spread"] - self.p.min_inlier_spread)
                    <= GATE_SPREAD_M)
            if r["closes"] != (key in port_cl):
                ties += near
                wrong += not near
            elif r["closes"]:
                Tp, Tr = port_cl[key].to(torch.float64), r["T"].to(
                    torch.float64)
                c = r["centre"].to(torch.float64)
                q = geo.matrix_to_quat(Tp[:3, :3].T @ Tr[:3, :3])
                gaps.append((r["inliers"], float(torch.linalg.norm(
                    (Tp[:3, :3] - Tr[:3, :3]) @ c + Tp[:3, 3] - Tr[:3, 3])),
                    float(torch.linalg.norm(geo.so3_log(q)))))
        wrong += sum(1 for key in port_cl if key not in ref_cl)
        n_ref = sum(r["closes"] for r in ref_cl.values())
        apart = sum(max(t, a) > TRANSFORM_TOL for _, t, a in gaps)
        trans = max((t for _, t, _ in gaps), default=0.0)
        rot = max((a for _, _, a in gaps), default=0.0)
        print(f"detect: last {n_check} sub-batches: {len(ref_cl)} candidates "
              f"verified, {n_ref} closures by the reference, {len(port_cl)} "
              f"by the {'control' if control is not None else 'port'}, "
              f"{wrong} apart clear of the gates, {ties} apart at a gate; "
              f"{len(gaps)} closures of both, {apart} of them with "
              f"transforms apart, the largest angle {rot!r} rad (reference "
              "inliers, gap um, urad): " + ", ".join(
                  f"({n}, {1e6 * t:.3f}, {1e6 * a:.3f})"
                  for n, t, a in sorted(gaps)), file=sys.stderr)
        lim = self.limits
        return [("pool_rows_mismatch", rows_bad, lim["pool_rows_mismatch"]),
                ("closures_mismatch", wrong / max(len(ref_cl), 1),
                 lim["closures_mismatch"]),
                ("closure_transforms_apart", apart / max(len(gaps), 1),
                 lim["closure_transforms_apart"]),
                ("closure_trans_gap_m", trans, lim["closure_trans_gap_m"])]

    def _pool_rows(self, slots: np.ndarray) -> dict:
        """The port's pool at ``slots``: its descriptors, validity, points
        and depth flags."""
        idx = torch.from_numpy(slots).to(self.device)
        d = self.det
        return {"desc": d._db_desc[idx].clone(),
                "valid": d._db_valid[idx].clone(),
                "p_cam": d._db_pcam[idx].clone(),
                "has_depth": d._db_hdep[idx].clone()}

    def _features(self, tags: list, dtype, batch: int = 16) -> dict:
        """The reference's features of the bank frames ``tags`` (robot ×
        bank + view) → {tag: row in ``out``}, the fields stacked."""
        parts = []
        for i in range(0, len(tags), batch):
            chunk = tags[i:i + batch]
            r = [t // self.bank for t in chunk]
            v = [t % self.bank for t in chunk]
            col = torch.stack([self.color[a][b] for a, b in zip(r, v)])
            dep = torch.stack([self.depth[a][b] for a, b in zip(r, v)])
            parts.append(ref.features(self.cam, col, dep, self.p, dtype))
        f = ref.Features(*(torch.cat(x) for x in zip(*parts)))
        return {"at": {t: i for i, t in enumerate(tags)}, "f": f}

    def _rows(self, feats: dict, tags) -> dict:
        """Pool rows as the reference holds them for slot tags (−1: a free
        slot, all invalid)."""
        f = feats["f"]
        K = self.p.max_keypoints
        out = {"desc": torch.zeros((len(tags), K, ref.N_WORDS),
                                   dtype=torch.int32, device=self.device),
               "valid": torch.zeros((len(tags), K), dtype=torch.bool,
                                    device=self.device),
               "p_cam": torch.zeros((len(tags), K, 3), dtype=f.p_cam.dtype,
                                    device=self.device),
               "has_depth": torch.zeros((len(tags), K), dtype=torch.bool,
                                        device=self.device)}
        live = [i for i, t in enumerate(tags) if t >= 0]
        if live:
            src = torch.tensor([feats["at"][int(tags[i])] for i in live],
                               device=self.device)
            dst = torch.tensor(live, device=self.device)
            for k in out:
                out[k][dst] = getattr(f, k)[src]
        return out

    def _closures(self, feats: dict, before: list, dtype) -> dict:
        """The reference's verified candidates of the checked sub-batches,
        each scored against the pool as it stood before its sub-batch →
        {(from robot, from t, to robot, to t): {"closes", "inliers",
        "spread", "T", "centre"}}: T maps the keyframe's camera into the
        candidate's, "centre" is the keyframe's inlier centroid. RANSAC's
        triples come from the detector's stream: a generator seeded with
        97 × the keyframes ingested before the sub-batch."""
        p = self.p
        out = {}
        first = len(self.log) - len(before)
        mc = min(p.max_candidates, p.max_keyframes)
        n = sum(len(items) for items in self.log[:first])
        for tb, items in zip(before, self.log[first:]):
            rng = torch.Generator(device=self.device)
            rng.manual_seed(97 * n)
            n += len(items)
            if not (tb.client >= 0).any():
                continue
            pool = self._rows(feats, tb.tag)
            q = self._rows(feats, np.array([r * self.bank + v
                                            for r, _, v in items]))
            qf = ref.Features(None, q["valid"], q["desc"], q["p_cam"],
                              q["has_depth"])
            elig = torch.from_numpy(np.stack([
                tb.eligible(r, t, p.min_time_separation)
                for r, t, _ in items])).to(self.device)
            score = ref.scores(qf, pool["desc"], pool["valid"], p)
            top, cand = ref.candidates(score, elig, mc)
            b = torch.arange(len(items), device=self.device) \
                .repeat_interleave(mc)
            s = cand.reshape(-1)
            a = ref.Features(None, pool["valid"][s], pool["desc"][s],
                             pool["p_cam"][s], pool["has_depth"][s])
            bq = ref.Features(None, qf.valid[b], qf.desc[b], qf.p_cam[b],
                              qf.has_depth[b])
            T, inl, spread, centre = ref.verify(a, bq, p, rng)
            top, s = top.reshape(-1).tolist(), s.tolist()
            inl, spread = inl.tolist(), spread.tolist()
            for i, (bi, si) in enumerate(zip(b.tolist(), s)):
                if top[i] < 0 or tb.client[si] < 0:
                    continue
                r, t, _ = items[bi]
                key = (int(tb.client[si]), float(tb.t[si]), r, t)
                out[key] = {"closes": ref.closes(p, top[i], inl[i],
                                                 spread[i]),
                            "inliers": inl[i], "spread": spread[i],
                            "T": T[i], "centre": centre[i]}
        return out
