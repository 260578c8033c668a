"""Closed-loop stream of one robot: 640×480 RGB-D frames through
``HostMapper.step_batch`` in fixed windows, as fast as the mapper takes
them, with the sensor's timestamps advancing; a submap every
``submap_interval`` of sensor time and the local pose graph solved
(``optimize_local``) right after each rollover; after ``mission_submaps``
submaps the robot starts a new mission on a fresh map, so the pool never
saturates (saturation changes the work).

End to end: ``device_ms_per_frame`` = the card's busy time over the
window (the union of its kernels and copies under a lean trace) / the
frames integrated in it. The closed-loop rate, frames integrated in the
window / the window, fenced at its end, is paced by the host and is read
per layer, in the traced run, whose window runs bare. The check
re-integrates sampled submaps of the final map with the plain reference
from the same frames and odometry.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from slambench.harness import port, trace
from slambench.reference import compare, geometry as geo, tsdf as ref_tsdf
from slambench.traffic import synthetic as syn

# the cut that tests/tiny.py applies on the CPU, beyond its common camera
# and tsdf cut: to the traffic file ("mix") and to the configuration
# sections this driver reads ("config"); a plain expression, read unrun
TINY = {"mix": {"window_frames": 10, "lap_frames": 20, "mission_submaps": 3,
                "max_frames": 3000, "trace_windows": 2},
        "config": {"mapper": {"max_submaps": 4, "submap_interval": 20 / 30}}}


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.cuda = device.type == "cuda"
        self.cam = syn.Camera.of(cfg)
        self.hz = cfg["camera"]["rate_hz"]
        self.win = mix["window_frames"]
        self.lap = mix["lap_frames"]
        self.per_submap = int(round(cfg["mapper"]["submap_interval"]
                                    * self.hz))
        self.mission_frames = mix["mission_submaps"] * self.per_submap
        self.limits = mix["limits"]
        self.frame = 0           # next global frame index
        self.mission_starts = [0]
        self.rec = None          # the traced run's record

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        self._inputs()
        # warm-up: two windows across a rollover, the local solve and a
        # mission reset, the second under the window's lean trace (the
        # profiler's first start is slow); the window then starts on a
        # fresh map at frame 0
        self.mapper = self.sm.HostMapper(self.mcfg, device=self.device)
        self._step(0, 0.0)
        r = trace.device_busy(lambda: self._step(
            self.win, self.cfg["mapper"]["submap_interval"]), self.cuda)
        print("stream: set-up's trace: start {start_s:.3f} s, stop "
              "{stop_s:.3f} s, read {read_s:.3f} s".format(**r),
              file=sys.stderr)
        self._new_mission()
        port.fence(self.device)

    def _inputs(self) -> None:
        """The port's library and configuration; the lap rendered on the
        card and the odometry, from the seed."""
        from coxgraph_tpu_torch.mapper import submap_mapper as sm

        self.sm = sm
        port.load_kernels(self.device)
        self.mcfg = port.mapper_config(self.cfg)
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        scene = syn.default_room(self.device)
        o = self.mix["orbit"]
        start = rng.uniform(0.0, 2 * math.pi)
        gt = syn.orbit(self.lap, scene.room_center.cpu().numpy()
                       .astype(np.float64), o["radius"], o["height"], start)
        self.depth, self.col8 = syn.render_lap(
            scene, self.cam, gt, gen, self.cfg["depth_noise"], self.device)
        n = self.mix["max_frames"]
        self.odom = syn.drifting_odometry(gt[np.arange(n) % self.lap], rng,
                                          self.cfg["odometry"])
        self.odom32 = self.odom.astype(np.float32)
        self.ts = np.arange(n, dtype=np.float64) / self.hz

    def _new_mission(self) -> None:
        self.mapper = None
        self.mapper = self.sm.HostMapper(self.mcfg, device=self.device)

    def _frames(self, i: int):
        a = i % self.lap
        return (self.depth[a:a + self.win],
                syn.colour_f32(self.col8[a:a + self.win]))

    def _step(self, i: int, t0: float = None) -> None:
        """One window of frames from global frame ``i``."""
        depths, cols = self._frames(i)
        ts = self.ts[i:i + self.win] if t0 is None else \
            self.ts[:self.win] + t0
        with trace.span("step_batch"):
            started = self.mapper.step_batch(
                depths, cols, self.odom32[i:i + self.win], ts)
        if started:
            with trace.span("optimize_local"):
                self.sm.optimize_local(self.mcfg, self.mapper.state)

    def _advance(self) -> bool:
        """The next window of the stream, a mission reset first when the
        mission has all its submaps → False once the precomputed odometry
        is spent (the stream then ends)."""
        if self.frame + self.win > self.odom.shape[0]:
            return False
        if self.frame - self.mission_starts[-1] >= self.mission_frames:
            with trace.span("new_mission"):
                self._new_mission()
            self.mission_starts.append(self.frame)
        self._step(self.frame)
        self.frame += self.win
        return True

    # -- measurement -------------------------------------------------------

    def trace(self) -> dict:
        """A profiled stretch and a sync-counted stretch of the stream."""
        n = self.mix["trace_windows"]
        f0 = self.frame

        def stretch():
            for _ in range(n):
                self._advance()

        rec = self.rec = trace.profile(stretch)
        frames = self.frame - f0
        rec["frames"] = frames
        rec["k1_bytes"] = self._k1_bytes(f0, frames)
        f1 = self.frame
        _, rec["syncs"] = trace.count_syncs(stretch)
        rec["sync_frames"] = self.frame - f1
        return rec

    def _k1_bytes(self, f0: int, frames: int) -> float:
        """Bytes K1 has to move for frames [f0, f0 + frames): each block
        the reference's allocation names, read and written (sdf, weight,
        colour: 160 KiB at 16³), and the frame's depth and planar colour
        read once."""
        g = ref_tsdf.Grid.of(self.cfg)
        v3 = g.voxels_per_side ** 3
        row = 2 * 4 * 5 * v3
        img = 4 * 4 * self.cam.width * self.cam.height
        total = 0.0
        for i in range(f0, f0 + frames):
            anchor = self._anchor(i)
            T = geo.relative(anchor, torch.from_numpy(self.odom32[i]))
            total += row * ref_tsdf.touched_blocks(
                g, self.cam, self.depth[i % self.lap],
                T.to(self.device)) + img
        return total

    def _anchor(self, i: int) -> torch.Tensor:
        """The odometry pose at the start of frame i's submap."""
        m0 = max(f for f in self.mission_starts if f <= i)
        k0 = m0 + ((i - m0) // self.per_submap) * self.per_submap
        return torch.from_numpy(self.odom32[k0])

    def window(self, seconds: float) -> dict:
        """Frames streamed closed loop for ``seconds``. Untraced runs read
        the card's busy time over the whole window; the traced run's
        window runs bare and its rate goes to the record."""
        f0 = self.frame

        def stream():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds and self._advance():
                pass

        if self.rec is None:
            r = trace.device_busy(stream, self.cuda)
        else:
            port.fence(self.device)
            t0 = time.perf_counter()
            stream()
            port.fence(self.device)
            r = {"window_s": time.perf_counter() - t0}
        n = self.frame - f0
        print(f"stream: {n} frames in {r['window_s']!r} s", file=sys.stderr)
        if "busy_s" in r:
            print("stream: the card busy {busy_s!r} s; the trace's start "
                  "{start_s:.3f} s, stop {stop_s:.3f} s, read {read_s:.3f} s"
                  .format(**r), file=sys.stderr)
        if self.rec is not None:
            self.rec["frames_per_s"] = n / r["window_s"]
            return {"attempted": n, "failed": 0}
        return {"device_ms_per_frame": 1e3 * r["busy_s"] / max(n, 1),
                "attempted": n, "failed": 0}

    # -- correctness -------------------------------------------------------

    def check(self, control=None) -> list:
        """Sampled submaps of the final map against the reference
        re-integrating their frames → [(name, value, limit)]. ``control``
        (a dtype): the reference in that precision stands in for the
        port."""
        m0, end = self.mission_starts[-1], self.frame
        n_sub = (end - m0 + self.per_submap - 1) // self.per_submap
        rng = np.random.default_rng(self.seed + 1)
        pick = {n_sub - 1}
        if n_sub > 1:
            pick.add(int(rng.integers(0, n_sub - 1)))
        rows = {}
        if control is None:
            for k in sorted(pick):
                rows[k] = port.layer_rows(self.mapper.state.collection.layers,
                                          k)
        self.mapper = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        g = ref_tsdf.Grid.of(self.cfg)
        worst = {"blocks_mismatch": 0.0, "voxels_mismatch": 0.0}
        for k in sorted(pick):
            lo = m0 + k * self.per_submap
            hi = min(lo + self.per_submap, end)
            ref = self._reference(g, lo, hi, torch.float32)
            test = (self._reference(g, lo, hi, control).rows()
                    if control is not None else rows.pop(k))
            r = compare.layers(test, ref.rows(), ref.tie[:ref.n])
            print(f"stream: submap {k}: {r['blocks']} blocks, "
                  f"{r['voxels']} observed voxels, {r['voxels_bad']} "
                  f"mismatched, {r['voxels_bad_at_ties']} of them at "
                  "rounding ties", file=sys.stderr)
            for key in worst:
                worst[key] = max(worst[key], r[key])
            del ref, test
        return [(k, v, self.limits[k]) for k, v in worst.items()]

    def _reference(self, g, lo: int, hi: int, dtype) -> ref_tsdf.Layer:
        layer = ref_tsdf.Layer(g, self.device, dtype)
        anchor = torch.from_numpy(self.odom32[lo])
        for i in range(lo, hi):
            T = geo.relative(anchor, torch.from_numpy(self.odom32[i]))
            a = i % self.lap
            ref_tsdf.integrate(layer, self.cam, self.depth[a],
                               syn.colour_f32(self.col8[a]),
                               T.to(self.device))
        return layer
