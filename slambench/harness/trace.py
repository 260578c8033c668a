"""What a traced run reads: a stretch of work under ``torch.profiler``
(kernel table, launches, the device's busy union, the longest idle gaps
and what the host was doing in them, the program's spans) and a stretch
under CUDA's sync debug mode (host syncs counted).

The profiler arithmetic is the one of ``chip_smoke.profiled`` and
``tools/profile_torch_*.py``, copied; the busy time is the union of the
device-side intervals, so overlapping events are not counted twice. The
driver's ``slambench.`` ranges and the port's ``cox.`` ranges (its
program spans, on while ``port.tracing`` is) show on the device's
timeline too: they are annotations, not work, and are left out.
"""

from __future__ import annotations

import bisect
import time
import warnings
from collections import namedtuple

import torch

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
SPAN_PREFIX = "slambench."
PROGRAM_PREFIX = "cox."          # coxgraph_tpu_torch.runtime.SPAN_PREFIX
ANNOTATIONS = (SPAN_PREFIX, PROGRAM_PREFIX)
NONE = "(none)"                  # what no program span holds

# one profiler event, in ns on one clock
Event = namedtuple("Event", "name device start end tid corr linked")


def span(name: str):
    """A driver span: a ``record_function`` range the traced run sees as
    the host's activity around its device gaps."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _fence() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _ns(ev, what: str) -> float:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, what + "_us")()) * 1e3


def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def _union(intervals):
    """Sum of the union of (start, end) intervals, and the gaps between
    the merged intervals as (start, end)."""
    total, gaps = 0.0, []
    cur = None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def _label(cpu, t: float) -> str:
    """The innermost driver span, the innermost program span (where one
    is open) and the innermost host op around t."""
    around = [(e - s, n) for s, e, n in cpu if s <= t <= e]
    spans = [x for x in around if x[1].startswith(SPAN_PREFIX)]
    prog = [x for x in around if x[1].startswith(PROGRAM_PREFIX)]
    ops = [x for x in around if not x[1].startswith(ANNOTATIONS)]
    parts = [min(spans)[1][len(SPAN_PREFIX):] if spans else "driver"]
    if prog:
        parts.append(min(prog)[1][len(PROGRAM_PREFIX):])
    parts.append(min(ops)[1] if ops else "host")
    return "/".join(parts)


def events(prof) -> list:
    """The profiler's events as ``Event`` tuples."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        out.append(Event(ev.name(), str(ev.device_type()).endswith("CUDA"),
                         s, s + _ns(ev, "duration"), ev.start_thread_id(),
                         ev.correlation_id(), ev.linked_correlation_id()))
    return out


def _work(e) -> bool:
    return e.device and not e.name.startswith(ANNOTATIONS)


def busy(evs: list):
    """The device's work in a trace of ``Event`` tuples → (the union of
    its intervals in ns, the gaps between them as (start, end))."""
    return _union([(e.start, e.end) for e in evs if _work(e)])


class _Innermost:
    """One thread's program spans, properly nested: the innermost one open
    at any moment (``at``: its index, or -1 for none)."""

    def __init__(self, spans: list):
        self.t, self.top = [], []
        stack = []
        for i in sorted(range(len(spans)),
                        key=lambda i: (spans[i].start, -spans[i].end)):
            while stack and spans[stack[-1]].end <= spans[i].start:
                j = stack.pop()
                self._mark(spans[j].end, stack[-1] if stack else -1)
            stack.append(i)
            self._mark(spans[i].start, i)
        while stack:
            j = stack.pop()
            self._mark(spans[j].end, stack[-1] if stack else -1)

    def _mark(self, t, top) -> None:
        if self.t and self.t[-1] == t:
            self.top[-1] = top
        else:
            self.t.append(t)
            self.top.append(top)

    def at(self, t) -> int:
        k = bisect.bisect_right(self.t, t) - 1
        return self.top[k] if k >= 0 else -1


def attribute(evs: list) -> dict:
    """The program's spans in a trace of ``Event`` tuples → {span name:
    {"n", "launches", "device_s", "kernels": {device op: s}}}. Each
    launch, and the device time of the work a runtime call issued (found
    by its correlation id), is charged to the innermost program span open
    on the calling thread when it was called; ``NONE`` holds what was
    issued outside every span or whose call is not in the trace. The
    ``slambench.`` and ``cox.`` annotations on the device are no work.
    ``tools/profile_torch_spans.breakdown``'s arithmetic, copied."""
    host = [e for e in evs if not e.device]
    by_tid = {}
    for e in host:
        if e.name.startswith(PROGRAM_PREFIX):
            by_tid.setdefault(e.tid, []).append(e)
    nests = {tid: (sp, _Innermost(sp)) for tid, sp in by_tid.items()}
    rows = {}

    def row(name):
        return rows.setdefault(name, {"n": 0, "launches": 0, "device_s": 0.0,
                                      "kernels": {}})

    def owner(e) -> str:
        sp, nest = nests.get(e.tid, ((), None))
        i = nest.at(e.start) if nest is not None else -1
        return sp[i].name[len(PROGRAM_PREFIX):] if i >= 0 else NONE

    for sp, _ in nests.values():
        for s in sp:
            row(s.name[len(PROGRAM_PREFIX):])["n"] += 1
    row(NONE)
    calls = {e.corr: e for e in host if e.name.startswith("cu")}
    for e in host:
        if e.name in LAUNCH_KEYS:
            row(owner(e))["launches"] += 1
    for w in filter(_work, evs):
        c = calls.get(w.corr) or calls.get(w.linked)
        r = row(owner(c) if c is not None else NONE)
        dt = (w.end - w.start) * 1e-9
        r["device_s"] += dt
        r["kernels"][w.name] = r["kernels"].get(w.name, 0.0) + dt
    return rows


def profile(fn) -> dict:
    """``fn()`` traced, fenced at both ends → the stretch's record:
    ``window_s`` (host wall), ``busy_s`` (union of device-side events),
    ``launches``, ``kernels`` {name: [count, device s]}, ``device_ops``
    and ``idle_gaps`` (the ten largest, labelled by the host's activity),
    ``spans`` (``attribute``: the program's spans, while the port's
    tracing is on; else ``NONE`` alone).
    """
    from torch.profiler import ProfilerActivity, profile as _profile

    _fence()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        _fence()
        wall = time.perf_counter() - t0
    table = prof.key_averages()
    kernels = {}
    for e in table:
        d = _device_us(e)
        if (str(e.device_type).endswith("CUDA") and d > 0
                and not e.key.startswith(ANNOTATIONS)):
            k = kernels.setdefault(e.key, [0, 0.0])
            k[0] += e.count
            k[1] += d * 1e-6
    launches = sum(e.count for e in table if e.key in LAUNCH_KEYS)
    evs = events(prof)
    busy_ns, gaps = busy(evs)
    cpu = [(e.start, e.end, e.name) for e in evs if not e.device]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(cpu, 0.5 * (a + b)), (b - a) * 1e-9]
            for a, b in gaps[:10]]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"out": out, "window_s": wall, "busy_s": busy_ns * 1e-9,
            "launches": launches, "kernels": kernels,
            "device_ops": [[k, v[1]] for k, v in ops], "idle_gaps": idle,
            "spans": attribute(evs)}


def device_busy(fn, cuda: bool = True) -> dict:
    """``fn()`` under a lean trace (kernels, copies and the runtime calls
    that launch them, no host ops), fenced at both ends → ``out``,
    ``window_s`` (host wall), ``busy_s`` (union of the device-side
    intervals, as in ``profile``) and the trace's own costs on the host:
    ``start_s`` (before ``fn``), ``stop_s`` (after it) and ``read_s``
    (the events read). Nothing is parsed into the profiler's tables.
    Without ``cuda`` the host's ops stand in for the device's, so the
    same path runs on the CPU."""
    from torch.profiler import ProfilerActivity, profile as _profile

    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    want = str(act).rsplit(".", 1)[-1]
    _fence()
    t = [time.perf_counter()]
    with _profile(activities=[act]) as prof:
        t.append(time.perf_counter())
        out = fn()
        _fence()
        t.append(time.perf_counter())
    t.append(time.perf_counter())
    dev, kind = [], None
    for ev in prof.profiler.kineto_results.events():
        d = ev.device_type()
        if kind is None and str(d).endswith(want):
            kind = d
        if d == kind and not ev.name().startswith(ANNOTATIONS):
            s = _ns(ev, "start")
            dev.append((s, s + _ns(ev, "duration")))
    busy_ns, _ = _union(dev)
    t.append(time.perf_counter())
    return {"out": out, "window_s": t[2] - t[1], "busy_s": busy_ns * 1e-9,
            "start_s": t[1] - t[0], "stop_s": t[3] - t[2],
            "read_s": t[4] - t[3]}


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` → (its
    result, the host syncs torch flagged) — ``chip_smoke.count_syncs``."""
    if not torch.cuda.is_available():
        return fn(), 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)
