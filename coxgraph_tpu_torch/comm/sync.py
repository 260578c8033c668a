"""Cross-topic time synchronization — a copy of
``coxgraph_tpu.comm.sync`` (host control code; the port keeps its own
copy). The message_filters
``ApproximateTime`` policy the reference client uses to pair its
recover-mode inputs (LayerWithTrajectory + mesh_pointcloud,
coxgraph_client.cpp:16-28, coxgraph_client.h:131-138).

Host-side control code, no device arrays: per-channel FIFO queues of
(stamp, msg); a set is emitted as soon as one message per channel exists
whose stamp spread is within ``slop`` seconds, earliest-first. Messages
older than an emitted set are discarded (the message_filters contract:
sets come out in order, every message is used at most once).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Tuple


class ApproximateTimeSynchronizer:
    """add(channel, stamp, msg) → list of emitted (stamp_avg, msgs) sets.

    ``channels`` names the inputs (len ≥ 2). ``slop`` is the max stamp
    spread within a set. ``queue_size`` bounds each channel's buffer
    (oldest dropped first), like message_filters' queue_size argument.
    An optional ``callback(msgs)`` fires per emitted set.
    """

    def __init__(self, channels: List[str], slop: float = 0.1,
                 queue_size: int = 10,
                 callback: Optional[Callable] = None):
        assert len(channels) >= 2
        self.channels = list(channels)
        self.slop = float(slop)
        self.queue_size = int(queue_size)
        self.callback = callback
        self._q: dict[str, Deque[Tuple[float, object]]] = {
            c: deque() for c in channels}

    def add(self, channel: str, stamp: float, msg) -> List[tuple]:
        q = self._q[channel]
        q.append((float(stamp), msg))
        if len(q) > self.queue_size:
            q.popleft()
        out = []
        while True:
            s = self._try_emit()
            if s is None:
                break
            out.append(s)
            if self.callback is not None:
                self.callback(*s[1])
        return out

    def _try_emit(self):
        qs = [self._q[c] for c in self.channels]
        if any(not q for q in qs):
            return None
        # pivot on the earliest head; pick the closest message to it in
        # every other channel; emit if the spread fits within slop
        heads = [q[0][0] for q in qs]
        pivot = min(heads)
        picks = []
        for q in qs:
            k = min(range(len(q)), key=lambda i: abs(q[i][0] - pivot))
            picks.append((k, q[k]))
        stamps = [p[1][0] for p in picks]
        if max(stamps) - min(stamps) <= self.slop:
            msgs = tuple(p[1][1] for p in picks)
            for q, (k, _) in zip(qs, picks):
                for _ in range(k + 1):   # drop the pick and older msgs
                    q.popleft()
            return (sum(stamps) / len(stamps), msgs)
        # no fit around this pivot: the earliest head can never pair up
        # (later messages only move further away) — discard it and retry
        qs[heads.index(pivot)].popleft()
        return self._try_emit()
