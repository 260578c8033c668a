"""Device helpers for runs that must happen on a CUDA GPU.

``require_cuda`` is the gate for every GPU measurement path: it raises
when no card is visible instead of quietly running on the CPU.
``ResourceSampler`` samples this process's CPU share and memory (the
fusion server's ``state_query`` carries one sample). ``Timers`` sums
scoped wall-clock times by name.

Program tracing: ``span(name)`` marks a stretch of the port's host code
and ``count(name, n)`` adds to a host-side counter. Both do nothing
until ``tracing(True)``; then a span opens a ``record_function`` range
``"cox." + name`` (which a ``torch.profiler`` trace places on the clock
of the card's kernels and copies) and adds its host wall time to one
process-wide ``Timers``, and ``snapshot()`` returns what was summed. A
span never fences the card, and a counter only adds values the host
already holds.

Kernel launches: every hand-written kernel's launches are counted here,
under its name, whether tracing is on or off (``add_launches``, called
by ``_build.EntryPoint``); ``launches(name)`` reads one count and
``snapshot()`` reports each as ``name + ".launches"``. This module
imports nothing from the package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def require_cuda() -> torch.device:
    """Return ``cuda:0``, or raise RuntimeError when no CUDA device is
    available. Never substitutes the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA GPU is required (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def gpu_identity() -> str:
    """The card's name and power limit, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first line: the card this process uses by default)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timers:
    """Aggregating scoped wall-clock timers, after voxblox timing::Timer /
    timing::Timing::Print (tsdf_recover.h:63-93); the JAX package's
    ``utils.runtime.Timers`` with a CUDA fence in place of
    ``block_until_ready``."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync: Optional[torch.Tensor] = None):
        """Time the body under ``name``. With ``sync`` (a tensor) the time
        ends after ``torch.cuda.synchronize`` of its device when that is a
        card; a CPU tensor needs no fence."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def report(self) -> str:
        lines = ["timers:"]
        for k in sorted(self.total):
            n = self.count[k]
            tot = self.total[k]
            lines.append(f"  {k:32s} n={n:6d} total={tot:8.3f}s "
                         f"mean={tot / n * 1e3:8.2f}ms")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(
            {k: {"n": self.count[k], "total_s": self.total[k]}
             for k in self.total}
        )


class ResourceSampler:
    """Process CPU and memory sampling (the reference's node_evaluator
    ["cpu", "mem"] modes, evaluation_config.yaml:1-2). Reads /proc;
    ``sample()`` returns the CPU share since the previous call and the
    resident set."""

    def __init__(self):
        self._last = None

    @staticmethod
    def _read():
        with open(f"/proc/{os.getpid()}/stat") as f:
            parts = f.read().split()
        utime, stime = int(parts[13]), int(parts[14])
        rss_pages = int(parts[23])
        tick = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        return (time.monotonic(), (utime + stime) / tick, rss_pages * page)

    def sample(self) -> dict:
        now = self._read()
        if self._last is None:
            self._last = now
            return {"cpu_pct": 0.0, "rss_mb": now[2] / 1e6}
        dt = max(now[0] - self._last[0], 1e-9)
        cpu = 100.0 * (now[1] - self._last[1]) / dt
        self._last = now
        return {"cpu_pct": cpu, "rss_mb": now[2] / 1e6}


# -- program tracing --------------------------------------------------------

SPAN_PREFIX = "cox."
_TRACING = False                 # set by tracing(), read by span() and count()
_OFF = contextlib.nullcontext()  # the one span handed out while off
_LOCK = threading.Lock()         # taken only while tracing is on
_TIMERS = Timers()               # span name → host wall time and count
_COUNTERS: Dict[str, int] = defaultdict(int)
_launch_counts: Dict[str, int] = {}  # kernel name → launches, always on


def tracing(on: bool) -> None:
    """Switch program tracing (``span`` and ``count``) on or off for the
    whole process. What was summed stays; ``snapshot`` reads it."""
    global _TRACING
    _TRACING = bool(on)


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        with _LOCK:
            _TIMERS.total[self.name] += dt
            _TIMERS.count[self.name] += 1
        return False


def span(name: str):
    """A context manager around one stretch of the port's host code. Off,
    the shared no-op context; on, a ``record_function`` range
    ``"cox." + name`` and the stretch's host wall time summed under
    ``name``."""
    if not _TRACING:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host value, never a tensor) to counter ``name`` while
    tracing is on."""
    if not _TRACING:
        return
    with _LOCK:
        _COUNTERS[name] += n


def add_launches(name: str, n: int) -> None:
    """Add ``n`` launches of kernel ``name``, tracing on or off (``n = 0``
    declares the name, so ``snapshot`` reports it before its first
    launch)."""
    _launch_counts[name] = _launch_counts.get(name, 0) + n


def launches(name: str) -> int:
    """Kernel ``name``'s launches so far in this process (0 before its
    first)."""
    return _launch_counts.get(name, 0)


def snapshot() -> dict:
    """What tracing has summed so far → ``{"spans": {name: {"n",
    "total_s"}}, "counters": {name: value}}``; the counters include every
    declared kernel's launches as ``name + ".launches"`` (``k1``, ``k2``,
    ``alloc``, ``esdf``: one entry each, declared when its wrapper module
    in ``ops`` is imported), counted whether tracing is on or not.
    Difference two snapshots to read a stretch."""
    with _LOCK:
        spans = json.loads(_TIMERS.as_json())
        counters = dict(_COUNTERS)
    counters.update((f"{name}.launches", n)
                    for name, n in _launch_counts.items())
    return {"spans": spans, "counters": counters}
