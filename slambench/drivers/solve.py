"""Closed-loop global solve of the two-client server: both robots map a
4-minute mission (each submap from every ``frame_stride``-th frame of its
10 s), the server pulls all their submaps with one fusion every
``refuse_interval`` of mission time, and the window calls
``CoxgraphServer.optimize`` back to back, as after a fusion, with the
caches held as the server holds them.

End to end: ``device_ms_per_optimize`` = the card's busy time over the
whole window (the union of its kernels and copies under a CUDA-only
trace, as the stream reads it) / the optimizes completed in it, each
ending in the solved poses read back. The host paces the optimizes, and
the host's speed moves their wall time by more than a bound can hold, so
the traced run times a bare stretch before its profiler starts and puts
its wall time per optimize in the record (``optimize_ms``), read per
layer. The trace's first start (some seconds) lies between the set-up
and the window: it is the benchmark's instrument, not the server's
set-up. The check re-integrates every
submap with the plain reference and solves the same graph with the plain
two-phase solve: the first optimize (set-up's) from the same start, and
the poses the window leaves, against the reference's fixed point.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from slambench.harness import port, trace
from slambench.reference import compare, geometry as geo
from slambench.reference import solve as ref_solve, tsdf as ref_tsdf
from slambench.traffic import synthetic as syn

# tests/tiny.py's CPU cut (see stream.TINY)
TINY = {"mix": {"lap_frames": 60, "submaps_per_robot": 6,
                "trace_optimizes": 1,
                "fusion": {"interval": 4.0, "to_offset": 1.0}},
        "config": {"mapper": {"max_submaps": 6, "submap_interval": 2.0},
                   "server": {"max_submaps": 12, "refuse_interval": 4.0},
                   "registration": {"max_points": 256,
                                    "max_reg_blocks": 128}}}


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.cuda = device.type == "cuda"
        self.cam = syn.Camera.of(cfg)
        self.hz = cfg["camera"]["rate_hz"]
        self.stride = mix["frame_stride"]
        self.per_submap = int(round(cfg["mapper"]["submap_interval"]
                                    * self.hz))
        self.n_sub = mix["submaps_per_robot"]
        self.limits = mix["limits"]
        self.rec = None          # the traced run's record

    # -- the mission, as inputs --------------------------------------------

    def _inputs(self) -> None:
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        scene = syn.default_room(self.device)
        lap = self.mix["lap_frames"]
        o = self.mix["orbit"]
        a0 = rng.uniform(0.0, 2 * math.pi)
        centre = scene.room_center.cpu().numpy().astype(np.float64)
        n = self.n_sub * self.per_submap
        off = self.cfg["client1_odom_offset_xyzyaw"]
        X = geo.np_to_matrix(np.array([math.cos(off[3] / 2), 0, 0,
                                       math.sin(off[3] / 2), *off[:3]]))
        self.gt, self.odom, self.depth, self.col8 = [], [], [], []
        for r in range(2):
            gt = syn.orbit(lap, centre, o["radius"], o["height"],
                           a0 + r * math.pi)
            d, c = syn.render_lap(scene, self.cam, gt[::self.stride], gen,
                                  self.cfg["depth_noise"], self.device)
            od = syn.drifting_odometry(gt[np.arange(n) % lap], rng,
                                       self.cfg["odometry"])
            if r == 1:     # robot 1's odometry lives in its own frame
                od = geo.np_from_matrix(np.linalg.inv(X)
                                        @ geo.np_to_matrix(od))
            self.gt.append(gt)
            self.odom.append(od.astype(np.float32))
            self.depth.append(d)
            self.col8.append(c)
        # fusions: robot 1 at t, robot 0 half a lap later, where both
        # cameras look at the same wall; T_from_to from the ground truth
        # with a detector's error drawn from the seed
        fu = self.mix["fusion"]
        self.fusions = []
        t = 0.0
        span = self.n_sub * self.cfg["mapper"]["submap_interval"]
        while t + fu["to_offset"] < span:
            tf, tt = t + fu["from_offset"], t + fu["to_offset"]
            gf = self.gt[1][self._lap_index(tf)]
            gto = self.gt[0][self._lap_index(tt)]
            rel = np.linalg.inv(geo.np_to_matrix(gf)) @ geo.np_to_matrix(gto)
            xi = np.concatenate([rng.normal(0, fu["rot_std"], 3),
                                 rng.normal(0, fu["trans_std"], 3)])
            T = geo.np_from_matrix(rel @ geo.np_exp_matrix(xi))
            self.fusions.append((1, tf, 0, tt, T.astype(np.float32)))
            t += fu["interval"]

    def _lap_index(self, t: float) -> int:
        return int(round(t * self.hz)) % self.mix["lap_frames"]

    def _frame(self, t: float) -> int:
        return int(round(t * self.hz))

    def _window_frames(self, k: int):
        """Global frame indices of submap k (every stride-th of its 10 s)."""
        return [k * self.per_submap + j
                for j in range(0, self.per_submap, self.stride)]

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from coxgraph_tpu_torch.mapper import submap_mapper as sm
        from coxgraph_tpu_torch.server import fusion_server as fs
        from coxgraph_tpu_torch.server.client_interface import \
            InProcessClient

        port.load_kernels(self.device)
        self._inputs()
        mcfg = port.mapper_config(self.cfg)
        self.clients, self.mappers = [], []
        for r in range(2):
            c = InProcessClient(r, mcfg, sm.create_mapper(mcfg, self.device))
            m = sm.HostMapper(mcfg, c.state)
            c.mapper = m
            self.clients.append(c)
            self.mappers.append(m)
        for k in range(self.n_sub):
            g = self._window_frames(k)
            for r in range(2):
                self.mappers[r].step_batch(
                    self.depth[r], syn.colour_f32(self.col8[r]),
                    self.odom[r][g], np.asarray(g, np.float64) / self.hz)
        self.server = fs.CoxgraphServer(port.server_config(self.cfg, mcfg),
                                        self.clients, self.device)
        self.server.control_trigger(False)
        msgs = [fs.MapFusionMsg(from_client=a, from_time=ta, to_client=b,
                                to_time=tb, T_from_to=T)
                for a, ta, b, tb, T in self.fusions]
        self.accepted = [bool(self.server.map_fusion(msgs[0]))]
        self.server.collect_all_submaps()
        self.accepted += [bool(self.server.map_fusion(m)) for m in msgs[1:]]
        self.server.control_trigger(True)
        self.first = self.poses = self._optimize()
        self.first_info = dict(self.server.fusion_log[-1]
                               if self.server.fusion_log else {})
        port.fence(self.device)

    def _optimize(self) -> np.ndarray:
        """One optimize → the solved poses; keeps the poses it started
        from (``self.prev``)."""
        self.prev = self.poses if hasattr(self, "poses") else None
        with trace.span("optimize"):
            self.server.optimize()
        self.poses = np.stack([s.T_G_submap for s in self.server.submaps])
        return self.poses

    # -- measurement -------------------------------------------------------

    def trace(self) -> dict:
        """A bare stretch timed on the host, then a profiled stretch and a
        sync-counted stretch of optimizes. The bare one comes first: once
        the profiler has run, the host issues the solve's launches slower
        for the rest of the process."""
        n = self.mix["trace_optimizes"]

        def stretch():
            for _ in range(n):
                self._optimize()

        port.fence(self.device)
        t0 = time.perf_counter()
        stretch()
        port.fence(self.device)
        bare = time.perf_counter() - t0
        rec = self.rec = trace.profile(stretch)
        rec["optimize_ms"] = 1e3 * bare / n
        rec["optimizes"] = n
        _, rec["syncs"] = trace.count_syncs(stretch)
        rec["sync_optimizes"] = n
        return rec

    def window(self, seconds: float) -> dict:
        """Optimizes back to back for ``seconds``. Untraced runs read the
        card's busy time over the whole window; the traced run's window
        runs bare (its wall time per optimize is read in ``trace``)."""
        def solve():
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < seconds:
                self._optimize()
                n += 1
            return n

        if self.rec is None:
            r = trace.device_busy(solve, self.cuda)
        else:
            port.fence(self.device)
            t0 = time.perf_counter()
            r = {"out": solve()}
            port.fence(self.device)
            r["window_s"] = time.perf_counter() - t0
        n = r["out"]
        print(f"solve: {n} optimizes in {r['window_s']!r} s", file=sys.stderr)
        failed = len(self.server.optimize_errors)
        if self.rec is not None:
            return {"attempted": n, "failed": failed}
        print("solve: the card busy {busy_s!r} s; the trace's start "
              "{start_s:.3f} s, stop {stop_s:.3f} s, read {read_s:.3f} s"
              .format(**r), file=sys.stderr)
        return {"device_ms_per_optimize": 1e3 * r["busy_s"] / n,
                "attempted": n, "failed": failed}

    # -- correctness -------------------------------------------------------

    def order(self):
        """(client, client submap) of each server submap, in the order the
        set-up's protocol adds them: the first fusion's two, then each
        robot's in turn."""
        a, _, b, _, _ = self.fusions[0]
        first = [(a, self._sub(self.fusions[0][1])),
                 (b, self._sub(self.fusions[0][3]))]
        rest = [(r, k) for r in range(2) for k in range(self.n_sub)
                if (r, k) not in first]
        return first + rest

    def _sub(self, t: float) -> int:
        return int(t // self.cfg["mapper"]["submap_interval"])

    def check(self, control=None) -> list:
        """The first optimize (set-up's, from the mission's own start)
        against the reference solving the same graph from the same start,
        and the window's last optimize against the reference solving from
        the poses that optimize started from (the program's state: the
        reference follows it one step). ``control`` (a dtype): the
        reference in that precision stands in for the program."""
        order = self.order()
        served = [(s.client_id, s.client_submap_id)
                  for s in self.server.submaps]
        ok_order = served == order and all(self.accepted)
        prev = torch.from_numpy(self.prev).to(self.device)
        self.server = self.clients = self.mappers = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference(torch.float32)
        first_ref = ref.solve()
        ref_info = dict(ref.info)
        last_ref = ref.solve(prev)
        if control is not None:
            low = self.reference(control)
            first = low.solve().to(torch.float32)
            last = low.solve(prev.to(control)).to(torch.float32)
        else:
            first = torch.from_numpy(self.first).to(self.device)
            last = torch.from_numpy(self.poses).to(self.device)
        print("solve: program", {k: self.first_info.get(k) for k in (
            "phase1_cost", "n_registration_pairs", "phase2_cost_trace")},
            file=sys.stderr)
        print("solve: reference", ref_info, file=sys.stderr)
        a = compare.poses(first, first_ref)
        b = compare.poses(last, last_ref)
        lim = self.limits
        return [("submaps_and_fusions_as_sent", 0.0 if ok_order else 1.0,
                 0.0),
                ("first_solve_trans_m", a["trans"],
                 lim["first_solve_trans_m"]),
                ("first_solve_rot_rad", a["rot"], lim["first_solve_rot_rad"]),
                ("last_solve_trans_m", b["trans"], lim["last_solve_trans_m"]),
                ("last_solve_rot_rad", b["rot"], lim["last_solve_rot_rad"])]

    def reference(self, dtype) -> ref_solve.Problem:
        """The graph as the reference builds it from the mission's inputs."""
        g = ref_tsdf.Grid.of(self.cfg)
        order = self.order()
        sid = {key: i for i, key in enumerate(order)}
        subs, anchors = [], []
        for r, k in order:
            layer = ref_tsdf.Layer(g, self.device, dtype)
            fr = self._window_frames(k)
            anchor = torch.from_numpy(self.odom[r][fr[0]])
            for j, f in enumerate(fr):
                T = geo.relative(anchor, torch.from_numpy(self.odom[r][f]))
                ref_tsdf.integrate(layer, self.cam, self.depth[r][j],
                                   syn.colour_f32(self.col8[r][j]),
                                   T.to(self.device))
            n = layer.n
            subs.append(ref_solve.Submap(
                client=r, grid=layer.grid, coords=layer.coords[:n].clone(),
                sdf=layer.sdf[:n].clone(), weight=layer.weight[:n].clone()))
            anchors.append(anchor.to(torch.float64))
            del layer
        anchors = torch.stack(anchors).to(self.device)
        cons = []
        eye = torch.eye(6, dtype=torch.float64, device=self.device)
        for (r, k), i in sid.items():
            j = sid.get((r, k + 1))
            if j is not None:
                cons.append((i, j, geo.relative(anchors[i], anchors[j]),
                             self.cfg["server"]["odom_sqrt_info"] * eye))
        for a, ta, b, tb, T in self.fusions:
            sa, sb = sid[(a, self._sub(ta))], sid[(b, self._sub(tb))]
            Ta = geo.relative(anchors[sa], torch.from_numpy(
                self.odom[a][self._frame(ta)]).to(self.device, torch.float64))
            Tb = geo.relative(anchors[sb], torch.from_numpy(
                self.odom[b][self._frame(tb)]).to(self.device, torch.float64))
            T_ab = geo.compose(geo.compose(Ta, torch.from_numpy(T).to(
                self.device, torch.float64)), geo.inverse(Tb))
            cons.append((sa, sb, T_ab,
                         self.cfg["server"]["fusion_sqrt_info"] * eye))
        skip = set()
        for (r, k), i in sid.items():
            j = sid.get((r, k + 1))
            if j is not None:
                skip.add((min(i, j), max(i, j)))
        fixed = next(i for i, (r, _) in enumerate(order)
                     if r == min(c for c, _ in order))
        return ref_solve.Problem(self.cfg, subs, anchors, cons, fixed, skip,
                                 dtype=dtype)
