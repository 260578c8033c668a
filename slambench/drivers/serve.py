"""Open-loop stream of one robot with its live map served: each
640×480 RGB-D frame is stepped (``HostMapper.step``, the robot's
per-frame path) when the sensor's schedule makes it due, and once every
``serve_period_s`` the live mesh (``HostMapper.live_mesh``) and the ESDF
(``ops.esdf.esdf_from_tsdf``) of every submap that took frames since the
last serve are built and read back, the reference's map publication
(map_server.h:90-94). One thread, as voxblox's server spins: a serve
delays the frames behind it, and they catch up after it.

A serve starts once every frame due before it is stepped, so a served
map holds every frame due before the serve began.

End to end: ``map_latency_p95_ms``, the 95th percentile over every frame
due in the window of (the moment the first served map that holds the
frame is read back) − (the frame's due time); a frame not served when
the window closes counts from its due time to the window's end. The
check compares a serve drawn from the seed and the last serve with the
reference's mesh and ESDF of the same frames.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from slambench.drivers import stream
from slambench.harness import port, trace
from slambench.reference import compare, esdf as ref_esdf, mesh as ref_mesh
from slambench.reference import tsdf as ref_tsdf
from slambench.traffic import synthetic as syn

POS_TOL = 1e-3     # m per triangle vertex: the served mesh's quantised
#                    readback errs by ≤ 0.1 mm, float32 by far less
RGB_TOL = 3e-3     # per vertex channel: the readback's 8-bit colour
ESDF_TOL = 1e-3    # m

# tests/tiny.py's CPU cut (see stream.TINY)
TINY = {"mix": {"window_frames": 10, "lap_frames": 20, "mission_submaps": 3,
                "max_frames": 3000, "rate_hz": 10, "serve_period_s": 0.5,
                "trace_seconds": 1.0},
        "config": {"mapper": {"max_submaps": 4, "submap_interval": 20 / 30}}}


class Driver(stream.Driver):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        super().__init__(cfg, mix, seed, device)
        self.rate = mix["rate_hz"]
        self.period = mix["serve_period_s"]
        self.serves = []         # (start, end) host seconds of each serve
        self.chunks = []         # chunks re-meshed by each serve
        self.kept = {}           # serve index → what the check compares

    def setup(self) -> None:
        from coxgraph_tpu_torch.ops import esdf as esdf_ops

        self.esdf_ops = esdf_ops
        e = self.cfg["esdf"]
        self.ecfg = esdf_ops.EsdfConfig(
            max_distance=e["max_distance"],
            full_connectivity=e["full_connectivity"],
            extra_iters=e["extra_iters"])
        self._inputs()
        # warm-up: a submap's first frames, a serve, a rollover with its
        # local solve, a serve of both submaps, then a fresh mission
        self.mapper = self.sm.HostMapper(self.mcfg, device=self.device)
        self.frame = 0
        for g in range(3):
            self._frame(g, 0.0)
        self._serve([0], None, keep=False)
        self._frame(3, self.cfg["mapper"]["submap_interval"])
        self._serve([0, 1], None, keep=False)
        self._new_mission()
        port.fence(self.device)
        self.serves, self.chunks = [], []
        self.frame = 0

    def _frame(self, g: int, t_shift: float = None) -> None:
        a = g % self.lap
        t = self.ts[g] if t_shift is None else self.ts[g] + t_shift
        with trace.span("step"):
            started = self.mapper.step(self.depth[a],
                                       syn.colour_f32(self.col8[a]),
                                       self.odom32[g], float(t))
        if started:
            with trace.span("optimize_local"):
                self.sm.optimize_local(self.mcfg, self.mapper.state)

    def _serve(self, submaps, upto, keep: bool = True) -> None:
        """Mesh and ESDF of ``submaps``, read back; ``upto``: the frames
        stepped so far (kept for the check with the served outputs)."""
        sm, spec = self.sm, self.mcfg.spec
        m = self.cfg["mesh"]
        t0 = time.perf_counter()
        chunks = 0
        out = {}
        with trace.span("serve"):
            for k in submaps:
                mesher = self.mapper.live_mesher(
                    k, min_weight=m["min_weight"], max_tris=m["max_tris"])
                before = mesher.chunks_remeshed
                verts, cols = self.mapper.live_mesh(
                    k, min_weight=m["min_weight"], max_tris=m["max_tris"])
                chunks += mesher.chunks_remeshed - before
                layer = sm.get_layer(self.mapper.state.collection.layers, k)
                e = self.esdf_ops.esdf_from_tsdf(spec, layer, self.ecfg)
                n = int(layer.num_blocks)
                dist = e.dist[:n].cpu()
                if keep:
                    out[k] = (verts, cols, dist,
                              layer.block_coords[:n].cpu(), upto)
        self.serves.append((t0, time.perf_counter()))
        self.chunks.append(chunks)
        if keep and len(self.serves) - 1 in self.keep_idx:
            self.kept[len(self.serves) - 1] = out
        elif keep:
            self.kept["last"] = out

    def _submap_of(self, g: int) -> int:
        return (g - self.mission_starts[-1]) // self.per_submap

    def _open_loop(self, seconds: float) -> dict:
        """Frames at the sensor's rate and a serve every period for
        ``seconds`` → the latencies (s) of the frames due in it."""
        t0 = time.perf_counter()
        g0 = self.frame
        pending = []              # frames stepped, not served yet
        touched = set()
        lat = {}
        k = 1
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            i = self.frame - g0
            if i / self.rate <= now:
                if self.frame - self.mission_starts[-1] \
                        >= self.mission_frames:
                    self._new_mission()
                    self.mission_starts.append(self.frame)
                self._frame(self.frame)
                pending.append(i)
                touched.add(self._submap_of(self.frame))
                self.frame += 1
                continue
            if k * self.period <= now:
                self._serve(sorted(touched), self.frame)
                done = self.serves[-1][1] - t0
                for j in pending:
                    lat[j] = done - j / self.rate
                pending, touched = [], set()
                k += 1
                continue
            nxt = min((self.frame - g0) / self.rate, k * self.period)
            time.sleep(max(0.0, nxt - (time.perf_counter() - t0)))
        n_due = int(np.ceil(seconds * self.rate))
        out = [lat.get(j, seconds - j / self.rate) for j in range(n_due)]
        return {"latencies": out, "stepped": self.frame - g0}

    def trace(self) -> dict:
        s0 = len(self.serves)
        self.keep_idx = set()
        rec = trace.profile(lambda: self._open_loop(
            self.mix["trace_seconds"]))
        spans = self.serves[s0:]
        rec["serves"] = len(spans)
        rec["serve_s"] = [b - a for a, b in spans]
        rec["chunks"] = self.chunks[s0:]
        rec["frames"] = rec["out"]["stepped"]
        del rec["out"]
        return rec

    def window(self, seconds: float) -> dict:
        rng = np.random.default_rng(self.seed + 2)
        n = max(1, int(seconds / self.period) - 1)
        self.keep_idx = {len(self.serves) + int(rng.integers(0, n))}
        port.fence(self.device)
        r = self._open_loop(seconds)
        lat = np.asarray(r["latencies"])
        return {"map_latency_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "attempted": len(lat), "failed": 0}

    def check(self, control=None) -> list:
        """Each kept serve's mesh and ESDF against the reference's of the
        same frames. ``control`` (a dtype): the reference in that
        precision stands in for the program."""
        kept = [v for v in self.kept.values()]
        self.mapper = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        g = ref_tsdf.Grid.of(self.cfg)
        m0 = self.mission_starts[-1]
        worst = {"mesh_mismatch": 0.0, "esdf_mismatch": 0.0}
        for out in kept:
            for k, (verts, cols, dist, coords, upto) in out.items():
                lo = m0 + k * self.per_submap
                hi = min(lo + self.per_submap, upto)
                ref = self._reference(g, lo, hi, torch.float32)
                r_sums = self._mesh_sums(ref, g)
                r_dist = self._esdf(ref, g)
                if control is not None:
                    low = self._reference(g, lo, hi, control)
                    t_sums = self._mesh_sums(low, g)
                    t_dist = (low.coords[:low.n], self._esdf(low, g))
                else:
                    v = torch.from_numpy(np.ascontiguousarray(verts)).to(
                        self.device, torch.float64)
                    c = torch.from_numpy(np.ascontiguousarray(cols)).to(
                        self.device, torch.float64)
                    t_sums = ref_mesh.soup_sums(v, c, g.voxel_size)
                    t_dist = (coords.to(self.device, torch.int64),
                              dist.to(self.device))
                mr = ref_mesh.compare(t_sums, r_sums, POS_TOL, RGB_TOL)
                er = self._esdf_compare(t_dist, (ref.coords[:ref.n],
                                                 r_dist))
                print(f"serve: submap {k}, frames {hi - lo}: "
                      f"{mr['cells_bad']} of {mr['cells']} mesh cells and "
                      f"{er['bad']} of {er['voxels']} ESDF voxels differ",
                      file=sys.stderr)
                worst["mesh_mismatch"] = max(worst["mesh_mismatch"],
                                             mr["mesh_mismatch"])
                worst["esdf_mismatch"] = max(worst["esdf_mismatch"],
                                             er["share"])
        return [(k, v, self.limits[k]) for k, v in worst.items()]

    def _mesh_sums(self, ref, g):
        """The reference's mesh as the serve reads it back, in per-cell
        sums."""
        n = ref.n
        v, c = ref_mesh.triangles(
            ref.coords[:n], ref.sdf[:n], ref.weight[:n],
            ref.color[:n].reshape(n, -1), ref.grid, g,
            self.cfg["mesh"]["min_weight"])
        v, c = ref_mesh.quantized(v, c, ref.coords[:n],
                                  g.voxel_size * g.voxels_per_side)
        return ref_mesh.soup_sums(v.double(), c.double(), g.voxel_size)

    def _esdf(self, ref, g):
        n = ref.n
        return ref_esdf.esdf(ref.coords[:n], ref.sdf[:n], ref.weight[:n],
                             ref.grid, g, self.cfg["esdf"])

    @staticmethod
    def _esdf_compare(test, ref) -> dict:
        """ESDF rows matched by block coordinate: the share of voxels (of
        blocks on either side) whose distance differs by more than
        ESDF_TOL; a block on one side only counts whole."""
        kt, kr = compare._keys(test[0]), compare._keys(ref[0])
        union = torch.unique(torch.cat([kt, kr]))
        n, v3 = union.numel(), ref[1].shape[1]
        dev = ref[1].device
        dt = torch.full((n, v3), float("nan"), device=dev)
        dr = torch.full((n, v3), float("nan"), device=dev)
        dt[torch.searchsorted(union, kt)] = test[1].to(torch.float32)
        dr[torch.searchsorted(union, kr)] = ref[1].to(torch.float32)
        bad = ~(torch.abs(dt - dr) <= ESDF_TOL)
        return {"bad": int(bad.sum()), "voxels": n * v3,
                "share": float(bad.sum()) / max(n * v3, 1)}
