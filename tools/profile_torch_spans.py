#!/usr/bin/env python3
"""Where a benchmark cell's time goes inside the port, by program span,
on a CUDA GPU; and what program tracing costs when it is on.

    python3 tools/profile_torch_spans.py --cell client_vga.stream \
        --seeds 1,2 [--cost-pairs 3] [--seconds 5] [--out FILE]

For each seed the cell's ``slambench`` driver is set up as a run sets it
up, program tracing (``coxgraph_tpu_torch.runtime.tracing``) is switched
on, and the stretch that the cell's ``--trace 1`` run profiles (ten
stream windows, three optimizes, four seconds of the open loop) is traced
with ``torch.profiler``. The trace is read by ``breakdown``: for each
``cox.`` span its count, host time, host time outside its child spans,
the device time and launches issued inside it, and the device idle time
that falls in it (charged to the innermost span; ``(none)`` holds the
idle time outside every span), the counters' differences over the
stretch, and the longest idle gaps labelled
``<driver span>/<program span>/<host op>``. The ``cox.`` and
``slambench.`` ranges that the profiler also shows on the device's
timeline are annotations, not work, and are left out of the busy union.

Then the cost of tracing on, no profiler running: the host µs of one
span and one count, off and on (``span_cost``), and with ``--cost-pairs
K`` the stream's bare windows of ``--seconds`` (frames per second) or
the solve's optimizes (ms each), with tracing off and on in turns (off,
on, on, off; K times). One JSON line per seed on stdout and appended to
``--out``. Fails when no CUDA GPU is present.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import sys
import time
from collections import defaultdict, namedtuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from coxgraph_tpu_torch.runtime import SPAN_PREFIX as PROGRAM  # noqa: E402
from slambench.harness import trace  # noqa: E402

DRIVER = trace.SPAN_PREFIX  # the benchmark driver's spans
MARK = "profile_torch_spans.stretch"
NONE = "(none)"

Event = namedtuple("Event", "name device start end tid corr linked")


def kineto_events(prof) -> list:
    """The profiler's events as ``Event`` tuples (ns on one clock)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = trace._ns(ev, "start")
        out.append(Event(ev.name(), str(ev.device_type()).endswith("CUDA"),
                         s, s + trace._ns(ev, "duration"),
                         ev.start_thread_id(), ev.correlation_id(),
                         ev.linked_correlation_id()))
    return out


class Nest:
    """One thread's program spans, properly nested: each span's parent,
    and the innermost span at any moment (-1: none)."""

    def __init__(self, spans: list):
        self.spans = spans
        self.parent = [-1] * len(spans)
        self.t, self.top = [], []
        stack = []

        def close_until(t):
            while stack and spans[stack[-1]].end <= t:
                j = stack.pop()
                self._mark(spans[j].end, stack[-1] if stack else -1)

        for i in sorted(range(len(spans)),
                        key=lambda i: (spans[i].start, -spans[i].end)):
            close_until(spans[i].start)
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)
            self._mark(spans[i].start, i)
        close_until(float("inf"))

    def _mark(self, t, top) -> None:
        if self.t and self.t[-1] == t:
            self.top[-1] = top
        else:
            self.t.append(t)
            self.top.append(top)

    def at(self, t) -> int:
        k = bisect.bisect_right(self.t, t) - 1
        return self.top[k] if k >= 0 else -1

    def names(self, i) -> set:
        """The names of span ``i`` and of every span around it."""
        out = set()
        while i >= 0:
            out.add(self.spans[i].name[len(PROGRAM):])
            i = self.parent[i]
        return out or {NONE}

    def charge(self, a, b):
        """(innermost span or -1, length) of each piece of [a, b)."""
        k = bisect.bisect_right(self.t, a) - 1
        cur = a
        while cur < b:
            nxt = self.t[k + 1] if k + 1 < len(self.t) else float("inf")
            end = min(b, nxt)
            yield (self.top[k] if k >= 0 else -1), end - cur
            cur = end
            k += 1


def _idle(work: list, a, b) -> list:
    """The stretch [a, b) less the union of the device's work → [(start,
    end)]."""
    out, cur = [], a
    for s, e in sorted(work):
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, min(s, b)))
        cur = max(cur, e)
        if cur >= b:
            break
    if cur < b:
        out.append((cur, b))
    return [(s, e) for s, e in out if e > s]


def _innermost(events: list, t, keep) -> str:
    best = None
    for e in events:
        if e.start <= t <= e.end and keep(e.name):
            if best is None or e.end - e.start < best.end - best.start:
                best = e
    return best.name if best is not None else None


def breakdown(events: list, top: int = 10) -> dict:
    """The traced stretch (the host range named ``MARK``) by program span
    → ``window_s``, ``busy_s``, ``busy_with_annotations_s`` (the union
    with the ``cox.`` annotations counted as work), ``idle_s``,
    ``launches``, ``spans``
    {name: {n, host_s, self_host_s, device_s, launches, idle_s}} (with
    ``(none)`` for what no span holds), ``unlinked_device_s`` (device
    work whose launch was not found), ``driver`` {driver span: {n,
    wall_s, idle_s, idle_in_spans_s}} (the idle time inside the driver's
    spans, and the part of it that program spans hold) and
    ``idle_gaps``."""
    mark = next(e for e in events if not e.device and e.name == MARK)
    a, b, main = mark.start, mark.end, mark.tid
    work = [e for e in events if e.device
            and not e.name.startswith((PROGRAM, DRIVER, MARK))]
    # what the busy union reads if the program's annotations count as work
    annotated_ns, _ = trace._union(
        [(e.start, e.end) for e in events if e.device
         and not e.name.startswith((DRIVER, MARK))])
    host = [e for e in events if not e.device and e.name != MARK]
    by_tid = defaultdict(list)
    for e in host:
        if e.name.startswith(PROGRAM):
            by_tid[e.tid].append(e)
    nests = {tid: Nest(sp) for tid, sp in by_tid.items()}
    empty = Nest([])
    rows = defaultdict(lambda: {"n": 0, "host_s": 0.0, "self_host_s": 0.0,
                                "device_s": 0.0, "launches": 0,
                                "idle_s": 0.0})
    for nest in nests.values():
        child = [0.0] * len(nest.spans)
        for i, p in enumerate(nest.parent):
            if p >= 0:
                child[p] += nest.spans[i].end - nest.spans[i].start
        for i, s in enumerate(nest.spans):
            r = rows[s.name[len(PROGRAM):]]
            r["n"] += 1
            r["host_s"] += (s.end - s.start) * 1e-9
            r["self_host_s"] += (s.end - s.start - child[i]) * 1e-9
    runtime_calls = {e.corr: e for e in host if e.name.startswith("cu")}
    launches = 0
    for e in host:
        if e.name in trace.LAUNCH_KEYS:
            launches += 1
            nest = nests.get(e.tid, empty)
            for n in nest.names(nest.at(e.start)):
                rows[n]["launches"] += 1
    unlinked = 0.0
    for w in work:
        r = runtime_calls.get(w.corr) or runtime_calls.get(w.linked)
        if r is None:
            unlinked += (w.end - w.start) * 1e-9
            continue
        nest = nests.get(r.tid, empty)
        for n in nest.names(nest.at(r.start)):
            rows[n]["device_s"] += (w.end - w.start) * 1e-9
    busy_ns, _ = trace._union([(w.start, w.end) for w in work])
    gaps = _idle([(w.start, w.end) for w in work], a, b)
    nest = nests.get(main, empty)
    for s, e in gaps:
        for i, dt in nest.charge(s, e):
            name = nest.spans[i].name[len(PROGRAM):] if i >= 0 else NONE
            rows[name]["idle_s"] += dt * 1e-9
    rows[NONE]                       # present even when nothing falls there
    on_main = [e for e in host if e.tid == main]
    driver = defaultdict(lambda: {"n": 0, "wall_s": 0.0, "idle_s": 0.0,
                                  "idle_in_spans_s": 0.0})
    starts = [g[0] for g in gaps]
    for d in on_main:
        if not d.name.startswith(DRIVER):
            continue
        r = driver[d.name[len(DRIVER):]]
        r["n"] += 1
        r["wall_s"] += (d.end - d.start) * 1e-9
        k = max(bisect.bisect_right(starts, d.start) - 1, 0)
        while k < len(gaps) and gaps[k][0] < d.end:
            s, e = max(gaps[k][0], d.start), min(gaps[k][1], d.end)
            if e > s:
                r["idle_s"] += (e - s) * 1e-9
                r["idle_in_spans_s"] += sum(
                    dt for i, dt in nest.charge(s, e) if i >= 0) * 1e-9
            k += 1
    labels = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        t = 0.5 * (s + e)
        drv = _innermost(on_main, t, lambda n: n.startswith(DRIVER))
        i = nest.at(t)
        op = _innermost(on_main, t,
                        lambda n: not n.startswith((DRIVER, PROGRAM)))
        parts = [drv[len(DRIVER):] if drv else "driver"]
        if i >= 0:
            parts.append(nest.spans[i].name[len(PROGRAM):])
        parts.append(op or "host")
        labels.append(["/".join(parts), (e - s) * 1e-9])
    return {"window_s": (b - a) * 1e-9, "busy_s": busy_ns * 1e-9,
            "busy_with_annotations_s": annotated_ns * 1e-9,
            "idle_s": sum(e - s for s, e in gaps) * 1e-9,
            "launches": launches, "unlinked_device_s": unlinked,
            "spans": dict(sorted(rows.items(),
                                 key=lambda kv: -kv[1]["idle_s"])),
            "driver": dict(driver), "idle_gaps": labels}


def profile_spans(stretch) -> dict:
    """``stretch()`` under torch.profiler with program tracing on →
    ``breakdown`` of it, with the counters' differences over it."""
    from torch.profiler import ProfilerActivity, profile

    from coxgraph_tpu_torch import runtime

    act = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        act.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    runtime.tracing(True)
    try:
        before = runtime.snapshot()
        with profile(activities=act) as prof:
            with torch.profiler.record_function(MARK):
                stretch()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        after = runtime.snapshot()
    finally:
        runtime.tracing(False)
    rec = breakdown(kineto_events(prof))
    rec["counters"] = {k: v - before["counters"].get(k, 0)
                       for k, v in after["counters"].items()
                       if v != before["counters"].get(k, 0)}
    return rec


def _fence() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def stretch_of(d):
    """The stretch a cell's ``--trace 1`` run profiles, on driver ``d``."""
    mix = d.mix
    if mix["driver"] == "stream":
        return lambda: [d._advance() for _ in range(mix["trace_windows"])]
    if mix["driver"] == "solve":
        return lambda: [d._optimize() for _ in range(mix["trace_optimizes"])]
    d.keep_idx = set()
    return lambda: d._open_loop(mix["trace_seconds"])


def cost(d, pairs: int, seconds: float) -> dict:
    """Tracing off and on in turns (off, on, on, off; ``pairs`` times),
    no profiler: the stream's bare windows in frames per second, or the
    solve's optimizes in ms each."""
    from coxgraph_tpu_torch import runtime

    kind = d.mix["driver"]
    out = {"off": [], "on": []}
    for _ in range(pairs):
        for on in (False, True, True, False):
            runtime.tracing(on)
            try:
                _fence()
                t0 = time.perf_counter()
                if kind == "stream":
                    f0 = d.frame
                    while time.perf_counter() - t0 < seconds:
                        d._advance()
                    _fence()
                    v = (d.frame - f0) / (time.perf_counter() - t0)
                else:
                    n = 0
                    while time.perf_counter() - t0 < seconds:
                        d._optimize()
                        n += 1
                    v = 1e3 * (time.perf_counter() - t0) / n
            finally:
                runtime.tracing(False)
            out["on" if on else "off"].append(v)
    out["unit"] = "frames/s" if kind == "stream" else "ms"
    return out


def span_cost(n: int = 200_000) -> dict:
    """Host µs of one ``runtime.span`` enter and exit, and of one
    ``runtime.count``, with tracing off and on, no profiler running."""
    from coxgraph_tpu_torch import runtime

    out = {}
    for on in (False, True, False, True):   # the first pass warms up
        runtime.tracing(on)
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                with runtime.span("cost.probe"):
                    pass
            t1 = time.perf_counter()
            for _ in range(n):
                runtime.count("cost.probe")
            t2 = time.perf_counter()
        finally:
            runtime.tracing(False)
        key = "on" if on else "off"
        out["span_us_" + key] = 1e6 * (t1 - t0) / n
        out["count_us_" + key] = 1e6 * (t2 - t1) / n
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cost-pairs", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a rehearsal at a tiny size)")
    args = ap.parse_args()
    from coxgraph_tpu_torch import runtime
    from slambench.harness import core

    if args.cpu:
        device, card = torch.device("cpu"), "cpu"
    else:
        device = runtime.require_cuda()
        card = runtime.gpu_identity()
    c = core.cell(args.cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        d = c["driver"].Driver(c["config"], c["traffic"], seed, device)
        d.setup()
        rec = {"cell": args.cell, "seed": seed, "card": card,
               "trace": profile_spans(stretch_of(d)),
               "span_cost": span_cost()}
        if args.cost_pairs and d.mix["driver"] in ("stream", "solve"):
            rec["cost"] = cost(d, args.cost_pairs, args.seconds)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del d
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
