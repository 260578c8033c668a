"""Device helpers for runs that must happen on a CUDA GPU.

``require_cuda`` is the gate for every GPU measurement path: it raises
when no card is visible instead of quietly running on the CPU.
``ResourceSampler`` samples this process's CPU share and memory (the
fusion server's ``state_query`` carries one sample). ``Timers`` sums
scoped wall-clock times by name.
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
    resident set. ``start(rate_hz)`` / ``stop()`` run the periodic loop;
    ``summary()`` is the end-of-run rollup."""

    def __init__(self):
        self._last = None
        self.samples = []
        self._thread = None
        self._stop = None

    def start(self, rate_hz: float = 1.0) -> "ResourceSampler":
        """Sample periodically on a daemon thread until stop()."""
        if self._thread is not None:
            return self
        self._stop = threading.Event()
        self.sample()                       # baseline for the first delta

        def loop():
            while not self._stop.wait(1.0 / rate_hz):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> dict:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        return self.summary()

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0}
        cpu = [s["cpu_pct"] for s in self.samples]
        rss = [s["rss_mb"] for s in self.samples]
        return {"n": len(self.samples),
                "cpu_pct_mean": sum(cpu) / len(cpu),
                "cpu_pct_max": max(cpu),
                "rss_mb_max": max(rss)}

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
        rec = {"cpu_pct": cpu, "rss_mb": now[2] / 1e6}
        self.samples.append(rec)
        return rec
