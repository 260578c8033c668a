"""Keyframe database + loop-closure detection → MapFusion messages — port
of ``coxgraph_tpu.frontends.loop_detector``.

The whole keyframe descriptor database is matched brute force (on the card
by the Hamming kernel of ``ops.cuda_hamming``), candidates are ranked by
their count of mutual good matches and verified with batched 3-D/3-D
RANSAC. Matching and the top-K verifications of an ingest (or of a
sub-batch of ``batch_size`` frames) end in ONE device-to-host read of one
packed result tensor; the eligibility mask and the append slots go up with
non-blocking copies.

Capacity: the device database is a FIXED pool of
``LoopDetectorConfig.max_keyframes`` slots, written IN PLACE
(``index_copy_``; the JAX package donates the pools). On saturation the
OLDEST keyframe of the MOST-REPRESENTED client is evicted, with a warning,
counted in ``dropped_keyframes``.

Tracing (``runtime.span`` / ``runtime.count``, off by default): each
sub-batch and each single frame is described under ``detect.features``
(detection and description), then ingested under ``detect.ingest``,
which holds the leaf spans ``detect.eligibility`` (the host mask and its
upload), ``detect.match``
(the scoring launches over the pool), ``detect.verify`` (top-K, the
verification match, RANSAC and the spread), ``detect.read`` (the one
device-to-host read) and ``detect.append`` (slot allocation with eviction
and the in-place write); counters ``detect.keyframes``,
``detect.evictions``, ``detect.candidates`` (candidates verified) and
``detect.closures`` (messages emitted).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np
import torch

from .. import runtime
from ..ops import features as ft
from ..server.fusion_server import MapFusionMsg
from ..utils.tensorops import upload
from .synthetic import PinholeIntrinsics

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LoopDetectorConfig:
    features: ft.FeatureConfig = ft.FeatureConfig()
    min_match_score: int = 30          # good matches to shortlist a pair
    min_inliers: int = 15              # RANSAC gate (SAC threshold analog)
    min_time_separation: float = 3.0   # s, same-robot loop gate
    max_candidates: int = 2            # verified per new keyframe
    # minimum planar spread (m) of the RANSAC inlier cloud; 0 disables
    min_inlier_spread: float = 0.4
    keyframe_stride: float = 0.5       # s between stored keyframes
    sqrt_info: float = 10.0            # emitted measurement weight (0 ⇒
    #                                    emit None)
    max_keyframes: int = 2048          # device keyframe-pool capacity
    # database rows matched per step (bounds the plain version's
    # (batch, chunk, K, K) distance transient)
    match_chunk: int = 128
    # frames per fused ingest sub-batch (add_keyframes_batch)
    batch_size: int = 4


@dataclasses.dataclass
class Keyframe:
    client_id: int
    t: float
    kp: Optional[ft.Keypoints] = None  # not retained (the pools hold the
    #                                    device data); kept for API parity


def _count_matches(db_desc: Tensor, db_valid: Tensor, q_desc: Tensor,
                   q_valid: Tensor, cfg: ft.FeatureConfig,
                   match_chunk: int) -> Tensor:
    """Good mutual matches of each of B queries against every pool slot,
    ``match_chunk`` slots per step → (B, cap) int. On the card one kernel
    launch per step."""
    cap = db_desc.shape[0]
    counts = []
    for s in range(0, cap, match_chunk):
        mb, _ = ft.match_descriptors_batch(
            q_desc, q_valid, db_desc[None, s:s + match_chunk],
            db_valid[None, s:s + match_chunk], cfg)
        counts.append((mb >= 0).sum(-1))
    return torch.cat(counts, dim=1)


def _match_and_verify_batch(db_desc, db_valid, db_pcam, db_hdep,
                            elig_b: Tensor, q_b: ft.Keypoints,
                            cfg: ft.FeatureConfig, max_cand: int,
                            match_chunk: int,
                            generator: Optional[torch.Generator] = None):
    """B queries against the database: score every slot, take the top
    ``max_cand`` eligible slots (the lowest slot first among equal scores,
    as ``lax.top_k``), RANSAC-verify each. Batch members are matched
    against the database as it stood before the batch.

    elig_b: (B, cap) bool device mask. → (scores (B, max_cand), slots
    (B, max_cand), T (B, max_cand, 7), n_inliers (B, max_cand), spreads
    (B, max_cand)), all on the device; issues no device-to-host read."""
    with runtime.span("detect.match"):
        counts = _count_matches(db_desc, db_valid, q_b.desc, q_b.valid, cfg,
                                match_chunk)
    with runtime.span("detect.verify"):
        return _verify_batch(db_desc, db_valid, db_pcam, db_hdep, elig_b,
                             q_b, counts, cfg, max_cand, generator)


def _verify_batch(db_desc, db_valid, db_pcam, db_hdep, elig_b: Tensor,
                  q_b: ft.Keypoints, counts: Tensor, cfg: ft.FeatureConfig,
                  max_cand: int, generator: Optional[torch.Generator]):
    """The top ``max_cand`` eligible slots of each query by its match
    counts (B, cap), RANSAC-verified → ``_match_and_verify_batch``'s
    tuple."""
    scores = torch.where(elig_b, counts, -1)
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :max_cand], top_idx[:, :max_cand]

    B = q_b.desc.shape[0]
    kf = ft.Keypoints(uv=None, response=None, valid=db_valid[top_idx],
                      desc=db_desc[top_idx], p_cam=db_pcam[top_idx],
                      has_depth=db_hdep[top_idx])

    def per_cand(x):
        return x[:, None].expand(B, max_cand, *x.shape[1:])

    q = ft.Keypoints(uv=None, response=None, valid=per_cand(q_b.valid),
                     desc=per_cand(q_b.desc), p_cam=per_cand(q_b.p_cam),
                     has_depth=per_cand(q_b.has_depth))
    Ts, n_inls, spreads = ft.estimate_relative_pose(
        kf, q, cfg, generator=generator, return_spread=True)
    return top_scores, top_idx, Ts, n_inls, spreads


def _match_and_verify(db_desc, db_valid, db_pcam, db_hdep, elig: Tensor,
                      q: ft.Keypoints, cfg: ft.FeatureConfig, max_cand: int,
                      match_chunk: int,
                      generator: Optional[torch.Generator] = None):
    """One query (Keypoints (K, ...), elig (cap,)) → the tuple of
    ``_match_and_verify_batch`` without its batch axis."""
    out = _match_and_verify_batch(
        db_desc, db_valid, db_pcam, db_hdep, elig[None],
        ft.Keypoints(*(None if f is None else f[None] for f in q)),
        cfg, max_cand, match_chunk, generator)
    return tuple(x[0] for x in out)


def _read_results(scores, idx, Ts, n_inls, spreads):
    """The ONE device-to-host read of an ingest: the verify tuple packed
    into one f32 tensor (scores, slots and counts are exact in f32) →
    numpy (scores, idx, Ts, n_inls, spreads)."""
    f32 = torch.float32
    with runtime.span("detect.read"):
        packed = torch.cat([scores.to(f32)[..., None],
                            idx.to(f32)[..., None], Ts,
                            n_inls.to(f32)[..., None], spreads[..., None]],
                           dim=-1).cpu().numpy()
    return (packed[..., 0].astype(np.int64), packed[..., 1].astype(np.int64),
            packed[..., 2:9], packed[..., 9].astype(np.int64),
            packed[..., 10])


def _db_append_batch(db_desc, db_valid, db_pcam, db_hdep,
                     kps: ft.Keypoints, slots: Tensor) -> None:
    """Write B keyframes (fields (B, K, ...)) at device slots (B,) IN
    PLACE (the JAX package donates the pools instead)."""
    db_desc.index_copy_(0, slots, kps.desc)
    db_valid.index_copy_(0, slots, kps.valid)
    db_pcam.index_copy_(0, slots, kps.p_cam)
    db_hdep.index_copy_(0, slots, kps.has_depth)


def _db_append(db_desc, db_valid, db_pcam, db_hdep, kp: ft.Keypoints,
               slot: Tensor) -> None:
    """Write one keyframe at device slot ``slot`` (1,) IN PLACE."""
    _db_append_batch(db_desc, db_valid, db_pcam, db_hdep,
                     ft.Keypoints(*(None if f is None else f[None]
                                    for f in kp)), slot)


class LoopDetector:
    """Shared multi-robot keyframe database (the reference runs one such
    backend fed by every robot's keyframes). ``device=None`` means the
    card (``runtime.require_cuda()``); the CPU is used only when asked
    for."""

    def __init__(self, intr: PinholeIntrinsics,
                 cfg: LoopDetectorConfig = LoopDetectorConfig(),
                 device=None):
        self.intr = intr
        self.cfg = cfg
        self.device = (runtime.require_cuda() if device is None
                       else torch.device(device))
        cap = cfg.max_keyframes
        K = cfg.features.max_keypoints
        # slot-indexed host metadata (slots recycle under eviction)
        self.slots: List[Optional[Keyframe]] = [None] * cap
        self.n_keyframes = 0          # live slots
        self.total_keyframes = 0      # lifetime ingests
        self.dropped_keyframes = 0    # evictions (pool saturation counter)
        self._free = list(range(cap - 1, -1, -1))
        self._last_kf_time: dict[int, float] = {}
        # device-resident fixed pools, written in place
        dev = self.device
        self._db_desc = torch.zeros((cap, K, ft._N_WORDS), dtype=torch.int32,
                                    device=dev)
        self._db_valid = torch.zeros((cap, K), dtype=torch.bool, device=dev)
        self._db_pcam = torch.zeros((cap, K, 3), dtype=torch.float32,
                                    device=dev)
        self._db_hdep = torch.zeros((cap, K), dtype=torch.bool, device=dev)

    @property
    def keyframes(self) -> List[Keyframe]:
        """Live keyframes (slot order) — metadata only; descriptors and
        3-D points live in the device pools."""
        return [kf for kf in self.slots if kf is not None]

    def _pools(self):
        return self._db_desc, self._db_valid, self._db_pcam, self._db_hdep

    def _generator(self, generator: Optional[torch.Generator]):
        """The caller's generator, or one seeded as the JAX package seeds
        its key (``total_keyframes * 97``; the streams differ)."""
        if generator is not None:
            return generator
        g = torch.Generator(device=self.device)
        g.manual_seed(self.total_keyframes * 97)
        return g

    def _alloc_slot(self, client_id: int) -> int:
        """Free slot, or — at capacity — evict the OLDEST keyframe of the
        MOST-REPRESENTED client (the incoming keyframe counts toward its
        client, so alternating ingest stays exactly balanced)."""
        if self._free:
            self.n_keyframes += 1
            return self._free.pop()
        counts: dict[int, int] = {client_id: 1}
        for kf in self.slots:
            counts[kf.client_id] = counts.get(kf.client_id, 0) + 1
        target = max(sorted(counts), key=lambda c: counts[c])
        if not any(kf.client_id == target for kf in self.slots):
            target = max(sorted(c for c in counts if c != client_id),
                         key=lambda c: counts[c])
        slot = min((s for s, kf in enumerate(self.slots)
                    if kf.client_id == target),
                   key=lambda s: self.slots[s].t)
        self.dropped_keyframes += 1
        runtime.count("detect.evictions")
        if self.dropped_keyframes == 1 or self.dropped_keyframes % 256 == 0:
            warnings.warn(
                f"keyframe pool saturated ({self.cfg.max_keyframes}): "
                f"evicted client {target}'s oldest keyframe "
                f"(t={self.slots[slot].t:.2f}) — {self.dropped_keyframes} "
                "evicted so far; raise LoopDetectorConfig.max_keyframes",
                RuntimeWarning, stacklevel=4)
        return slot

    # -- ingest ---------------------------------------------------------

    def add_keyframe(self, client_id: int, t: float, color: Tensor,
                     depth: Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> List[MapFusionMsg]:
        """Ingest a frame (color (H, W, 3), depth (H, W) on the detector's
        device); returns verified loop closures as MapFusion messages
        (from = the stored keyframe, to = the new frame)."""
        last = self._last_kf_time.get(client_id)
        if last is not None and t - last < self.cfg.keyframe_stride - 1e-9:
            return []
        self._last_kf_time[client_id] = t
        return self._ingest_frame(client_id, t, color, depth, generator)

    def _ingest_frame(self, client_id: int, t: float, color: Tensor,
                      depth: Tensor, generator) -> List[MapFusionMsg]:
        """One frame past the stride gate: detection, then one ingest."""
        with runtime.span("detect.features"):
            kp = ft.detect_and_describe(self.intr, color, depth,
                                        self.cfg.features)
        return self.ingest_keypoints(client_id, t, kp, generator=generator)

    def _eligibility(self, client_id: int, t: float) -> np.ndarray:
        """(cap,) bool: live slots minus same-client-too-recent."""
        cfg = self.cfg
        elig = np.zeros((cfg.max_keyframes,), bool)
        for s_i, kf in enumerate(self.slots):
            if kf is None:
                continue
            if kf.client_id == client_id and \
                    abs(t - kf.t) < cfg.min_time_separation:
                continue
            elig[s_i] = True
        return elig

    def _gate_results(self, client_id: int, t: float, scores, idx, Ts,
                      n_inls, spreads) -> List[MapFusionMsg]:
        """Host gates on the (already-read) verify tuple → messages."""
        cfg = self.cfg
        out: List[MapFusionMsg] = []
        for r in range(len(scores)):
            if int(scores[r]) < cfg.min_match_score:
                continue
            kf = self.slots[int(idx[r])]
            if kf is None:
                continue
            if (int(n_inls[r]) >= cfg.min_inliers
                    and float(spreads[r]) >= cfg.min_inlier_spread):
                si = (cfg.sqrt_info * np.eye(6, dtype=np.float32)
                      if cfg.sqrt_info > 0 else None)
                out.append(MapFusionMsg(
                    from_client=kf.client_id, from_time=kf.t,
                    to_client=client_id, to_time=t,
                    T_from_to=np.array(Ts[r], np.float32), sqrt_info=si))
        return out

    def ingest_keypoints(self, client_id: int, t: float, kp: ft.Keypoints,
                         generator: Optional[torch.Generator] = None
                         ) -> List[MapFusionMsg]:
        """Keypoint-level entry (add_keyframe minus detection — remote
        frontends shipping descriptors, and capacity tests, feed here):
        one match+verify pass, one device-to-host read, one in-place
        append. ``kp`` fields (K, ...) on the detector's device."""
        with runtime.span("detect.ingest"):
            cfg = self.cfg
            msgs: List[MapFusionMsg] = []
            if self.n_keyframes > 0:
                with runtime.span("detect.eligibility"):
                    elig = self._eligibility(client_id, t)
                    elig_d = (upload(elig, self.device) if elig.any()
                              else None)
                if elig_d is not None:
                    mc = min(cfg.max_candidates, cfg.max_keyframes)
                    res = _read_results(*_match_and_verify(
                        *self._pools(), elig_d, kp, cfg.features, mc,
                        cfg.match_chunk, self._generator(generator)))
                    runtime.count("detect.candidates", mc)
                    msgs = self._gate_results(client_id, t, *res)
            with runtime.span("detect.append"):
                slot = self._alloc_slot(client_id)
                _db_append(*self._pools(), kp,
                           upload(np.array([slot], np.int64), self.device))
                self.slots[slot] = Keyframe(client_id=client_id, t=t)
            self.total_keyframes += 1
            runtime.count("detect.keyframes")
            runtime.count("detect.closures", len(msgs))
            return msgs

    def add_keyframes_batch(self, items,
                            generator: Optional[torch.Generator] = None
                            ) -> List[MapFusionMsg]:
        """Batched ingest: ``items`` = [(client_id, t, color, depth)].
        Stride-gates, then processes sub-batches of ``batch_size`` frames
        with one detection pass, one match/verify pass, ONE read and one
        in-place append each; the remainder rides the single path.

        Sub-batch members are matched against the database as of the
        sub-batch start, so two keyframes of the SAME sub-batch meet on
        the next ingest."""
        todo = []
        for cid, t, c, d in items:
            last = self._last_kf_time.get(cid)
            if last is not None and \
                    t - last < self.cfg.keyframe_stride - 1e-9:
                continue
            self._last_kf_time[cid] = t
            todo.append((cid, t, c, d))
        msgs: List[MapFusionMsg] = []
        B = self.cfg.batch_size
        while len(todo) >= B:
            chunk, todo = todo[:B], todo[B:]
            msgs.extend(self._ingest_chunk(chunk, generator))
        for cid, t, c, d in todo:
            msgs.extend(self._ingest_frame(cid, t, c, d, generator))
        return msgs

    def _ingest_chunk(self, chunk, generator) -> List[MapFusionMsg]:
        with runtime.span("detect.features"):
            colors = torch.stack([c for _, _, c, _ in chunk])
            depths = torch.stack([d for _, _, _, d in chunk])
            kps = ft.detect_and_describe_batch(self.intr, colors, depths,
                                               self.cfg.features)
        with runtime.span("detect.ingest"):
            return self._ingest_keypoints_batch(
                [(cid, t) for cid, t, _, _ in chunk], kps, generator)

    def _ingest_keypoints_batch(self, meta, kps: ft.Keypoints,
                                generator) -> List[MapFusionMsg]:
        """One sub-batch: ``meta`` = [(client_id, t)], ``kps`` fields
        (B, K, ...) → messages; one match+verify pass, one read, one
        in-place append.

        Slots are allocated member by member, each entered in the slot
        table before the next eviction is chosen, so the table ends as B
        single ingests leave it. (The JAX package allocates every member
        against the table as it stood before the sub-batch: at capacity
        its members evict the same slot, and a sub-batch that reaches
        capacity part-way raises — ROADMAP queue 3.)"""
        cfg = self.cfg
        msgs: List[MapFusionMsg] = []
        if self.n_keyframes > 0:
            with runtime.span("detect.eligibility"):
                elig = np.stack([self._eligibility(cid, t)
                                 for cid, t in meta])
                elig_d = upload(elig, self.device) if elig.any() else None
            if elig_d is not None:
                mc = min(cfg.max_candidates, cfg.max_keyframes)
                scores, idx, Ts, n_inls, spreads = _read_results(
                    *_match_and_verify_batch(
                        *self._pools(), elig_d, kps, cfg.features, mc,
                        cfg.match_chunk, self._generator(generator)))
                runtime.count("detect.candidates", mc * len(meta))
                for b, (cid, t) in enumerate(meta):
                    msgs.extend(self._gate_results(
                        cid, t, scores[b], idx[b], Ts[b], n_inls[b],
                        spreads[b]))
        with runtime.span("detect.append"):
            slots = []
            for cid, t in meta:
                s = self._alloc_slot(cid)
                self.slots[s] = Keyframe(client_id=cid, t=t)
                self.total_keyframes += 1
                slots.append(s)
            # a slot taken twice (a pool smaller than the sub-batch) keeps
            # its last member, as in the table: index_copy_ with repeated
            # indices would leave the device's pick to chance
            keep = sorted({s: b for b, s in enumerate(slots)}.values())
            if len(keep) < len(slots):
                rows = upload(np.array(keep, np.int64), self.device)
                kps = ft.Keypoints(*(None if f is None else f[rows]
                                     for f in kps))
                slots = [slots[b] for b in keep]
            _db_append_batch(*self._pools(), kps,
                             upload(np.asarray(slots, np.int64), self.device))
        runtime.count("detect.keyframes", len(meta))
        runtime.count("detect.closures", len(msgs))
        return msgs
