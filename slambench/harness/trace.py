"""What a traced run reads: a stretch of work under ``torch.profiler``
(kernel table, launches, the device's busy union, the longest idle gaps
and what the host was doing in them) and a stretch under CUDA's sync
debug mode (host syncs counted).

The profiler arithmetic is the one of ``chip_smoke.profiled`` and
``tools/profile_torch_*.py``, copied; the busy time is the union of the
device-side intervals, so overlapping events are not counted twice.
"""

from __future__ import annotations

import time
import warnings

import torch

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
SPAN_PREFIX = "slambench."


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
    """The innermost driver span and the innermost host op around t."""
    spans = [(e - s, n) for s, e, n in cpu
             if s <= t <= e and n.startswith(SPAN_PREFIX)]
    ops = [(e - s, n) for s, e, n in cpu
           if s <= t <= e and not n.startswith(SPAN_PREFIX)]
    sp = min(spans)[1][len(SPAN_PREFIX):] if spans else "driver"
    op = min(ops)[1] if ops else "host"
    return f"{sp}/{op}"


def profile(fn) -> dict:
    """``fn()`` traced, fenced at both ends → the stretch's record:
    ``window_s`` (host wall), ``busy_s`` (union of device-side events),
    ``launches``, ``kernels`` {name: [count, device s]}, ``device_ops``
    and ``idle_gaps`` (the ten largest, labelled by the host's activity).
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
                and not e.key.startswith(SPAN_PREFIX)):
            k = kernels.setdefault(e.key, [0, 0.0])
            k[0] += e.count
            k[1] += d * 1e-6
    launches = sum(e.count for e in table if e.key in LAUNCH_KEYS)
    dev, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        if str(ev.device_type()).endswith("CUDA"):
            # a driver span shows on the device's timeline too: not work
            if not ev.name().startswith(SPAN_PREFIX):
                dev.append((s, e))
        else:
            cpu.append((s, e, ev.name()))
    busy_ns, gaps = _union(dev)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(cpu, 0.5 * (a + b)), (b - a) * 1e-9]
            for a, b in gaps[:10]]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"out": out, "window_s": wall, "busy_s": busy_ns * 1e-9,
            "launches": launches, "kernels": kernels,
            "device_ops": [[k, v[1]] for k, v in ops], "idle_gaps": idle}


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
        if d == kind and not ev.name().startswith(SPAN_PREFIX):
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
