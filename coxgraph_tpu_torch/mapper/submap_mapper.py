"""Per-robot submap mapper — port of ``coxgraph_tpu.mapper.submap_mapper``
(the integration slice).

A SubmapCollection is one dataclass of tensors whose fields carry a
leading submap axis (S, ...). A submap = posed TSDF layer + time interval
+ in-submap pose history. Pose histories are stored in the submap frame,
so a pose-graph update of T_odom_submap re-poses a whole trajectory
segment.

Where the JAX package donated the state to a jitted function and got a
new one back, the port updates the state's tensors IN PLACE:
``start_submap``, ``integrate``, ``integrate_batch`` and
``consume_mesh_dirty`` mutate ``state`` (and return it), as do
``HostMapper.step`` and ``HostMapper.step_batch``. The active submap and
all per-frame values stay on the device: a frame issues no device-to-host
read.

The serving half: ``HostMapper.live_mesh`` / ``live_mesh_async`` /
``live_mesh_odom`` (incremental meshing from ``mesh_dirty``) and
``merged_layer`` (all submaps fused into one odom-frame layer).

The local pose graph: ``add_loop_closure``, ``optimize_local`` (LM over
the submap poses, IN PLACE), ``HostMapper.finish_map`` and
``trajectory`` (the submaps' histories re-posed by the optimized submap
poses), and ``mapper_step``, the read-per-frame step the fusion server's
tests drive.

Point-cloud sensors: ``integrate_points`` and ``HostMapper.step_points``
run the same submap pipeline through ``ops/points.py``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import runtime
from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..ops import merge as merge_ops
from ..ops import points as points_ops
from ..ops import tsdf as tsdf_ops
from ..ops.mesh_incremental import IncrementalMesher
from ..solver import pose_graph as pg
from ..utils.tensorops import put_row, where_fields

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static mapper parameters (the JAX package's fields and
    defaults)."""

    spec: vx.VoxelGridSpec = vx.VoxelGridSpec()
    integrator: tsdf_ops.TsdfIntegratorConfig = \
        tsdf_ops.TsdfIntegratorConfig()
    intrinsics: PinholeIntrinsics = PinholeIntrinsics()
    max_submaps: int = 32
    max_history: int = 512            # poses per submap history
    submap_interval: float = 10.0     # s
    max_constraints: int = 256
    odom_sqrt_info: float = 20.0      # odometry constraint confidence
    # solver settings of the LOCAL pose-graph solve (optimize_local);
    # None = pg.SolverConfig(); set huber_delta > 0 against outlier loop
    # closures; an explicit solver_cfg argument overrides
    local_solver: Optional[pg.SolverConfig] = None
    # absolute height priors on submap poses (odom z at submap creation);
    # 0 = off
    height_prior_stddev: float = 0.0
    # point-cloud integrator settings; None = derived from ``integrator``
    point_integrator: Optional[points_ops.PointIntegratorConfig] = None


@dataclasses.dataclass
class SubmapCollection:
    """Stacked submaps: every TsdfLayer field gains a leading (S,) axis."""

    layers: vx.TsdfLayer              # fields (S, ...)
    T_odom_submap: Tensor             # (S,7)
    start_time: Tensor                # (S,)
    end_time: Tensor                  # (S,)
    hist_stamps: Tensor               # (S,H)
    hist_poses: Tensor                # (S,H,7) T_submap_cam
    hist_count: Tensor                # (S,) int32
    num_submaps: Tensor               # () int32

    @property
    def active(self) -> Tensor:
        return torch.clamp(self.num_submaps - 1, min=0)


@dataclasses.dataclass
class MapperState:
    collection: SubmapCollection
    constraints: pg.RelPoseConstraints   # local pose graph (odometry chain)
    heights: pg.HeightConstraints        # absolute z priors
    frame_count: Tensor                  # () int32
    # largest touched-block union of any integrate_batch window, and the
    # running count of block updates dropped for lack of working-set room
    # (always 0 on the GPU path, which has no union cap)
    union_watermark: Tensor              # () int32
    dropped_union_blocks: Tensor         # () int32
    # per-submap updated-block bits (voxblox Block::updated(mesh)):
    # integrators OR in the slots whose voxels they wrote;
    # consume_mesh_dirty pops a row
    mesh_dirty: Tensor                   # (S, max_blocks) bool


def create_collection(cfg: MapperConfig, device) -> SubmapCollection:
    S, H = cfg.max_submaps, cfg.max_history
    spec = cfg.spec
    mb, v, g = spec.max_blocks, spec.voxels_per_side, spec.grid_dim
    f32, i32 = torch.float32, torch.int32
    layers = vx.TsdfLayer(
        sdf=torch.full((S, mb, v ** 3), spec.truncation, dtype=f32,
                       device=device),
        weight=torch.zeros((S, mb, v ** 3), dtype=f32, device=device),
        color=torch.zeros((S, mb, 3 * v ** 3), dtype=f32, device=device),
        block_index=torch.full((S, g, g, g), -1, dtype=i32, device=device),
        block_coords=torch.zeros((S, mb, 3), dtype=i32, device=device),
        num_blocks=torch.zeros((S,), dtype=i32, device=device),
    )
    ident = geo.identity(device)
    return SubmapCollection(
        layers=layers,
        T_odom_submap=ident[None].repeat(S, 1),
        start_time=torch.zeros((S,), dtype=f32, device=device),
        end_time=torch.zeros((S,), dtype=f32, device=device),
        hist_stamps=torch.zeros((S, H), dtype=f32, device=device),
        hist_poses=ident[None, None].repeat(S, H, 1),
        hist_count=torch.zeros((S,), dtype=i32, device=device),
        num_submaps=torch.zeros((), dtype=i32, device=device),
    )


def create_mapper(cfg: MapperConfig, device) -> MapperState:
    i32 = torch.int32
    return MapperState(
        collection=create_collection(cfg, device),
        constraints=pg.RelPoseConstraints.empty(cfg.max_constraints, device),
        heights=pg.HeightConstraints.empty(cfg.max_submaps, device),
        frame_count=torch.zeros((), dtype=i32, device=device),
        union_watermark=torch.zeros((), dtype=i32, device=device),
        dropped_union_blocks=torch.zeros((), dtype=i32, device=device),
        mesh_dirty=torch.zeros((cfg.max_submaps, cfg.spec.max_blocks),
                               dtype=torch.bool, device=device),
    )


def get_layer(layers: vx.TsdfLayer, k) -> vx.TsdfLayer:
    """Copy of submap ``k``'s layer (``k`` an int or 0-d device tensor).
    An int index is a fill on the device, not a host copy."""
    kk = (k.reshape(1).long() if isinstance(k, Tensor) else
          torch.full((1,), int(k), dtype=torch.long,
                     device=layers.sdf.device))
    return vx.TsdfLayer(**{f.name: getattr(layers, f.name).index_select(
        0, kk)[0] for f in dataclasses.fields(layers)})


def _row(x: Tensor, k: Tensor) -> Tensor:
    return x.index_select(0, k.reshape(1).long())[0]


def start_submap(cfg: MapperConfig, state: MapperState, T_odom_cam: Tensor,
                 t: Tensor, go: Optional[Tensor] = None,
                 height_prior: bool = True) -> MapperState:
    """Open a new submap anchored at the current odometry pose and chain an
    odometry constraint from the previous submap, IN PLACE. When the pool
    is saturated (num_submaps == max_submaps) the slot writes AND the
    constraint adds are dropped. ``go`` (a 0-d bool device tensor) makes
    the rollover conditional on the device: where it is False nothing
    changes (the fleet's per-robot ``lax.cond``, no host read). With
    ``cfg.height_prior_stddev > 0`` the submap's odom height is recorded
    as a prior unless ``height_prior`` is False (the fleet, whose solve
    takes no priors)."""
    col = state.collection
    S = cfg.max_submaps
    k = col.num_submaps.clone()                  # the new slot
    if go is not None:                           # slot S: every write drops
        k = torch.where(go, k, S)
    prev = torch.clamp(k - 1, min=0)
    T_prev_new = geo.relative(_row(col.T_odom_submap, prev), T_odom_cam)

    put_row(col.T_odom_submap, k, T_odom_cam)
    put_row(col.start_time, k, t)
    put_row(col.end_time, k, t)
    put_row(col.hist_count, k, 0)
    n_new = torch.clamp(k + 1, max=S)
    col.num_submaps.copy_(n_new if go is None else
                          torch.where(go, n_new, col.num_submaps))

    in_pool = k < S
    eye = torch.eye(6, dtype=torch.float32, device=k.device)
    state.constraints = where_fields(
        (k > 0) & in_pool,
        state.constraints.add(prev, k, T_prev_new, cfg.odom_sqrt_info * eye),
        state.constraints)
    if height_prior and cfg.height_prior_stddev > 0:
        state.heights = where_fields(
            in_pool,
            state.heights.add(k, T_odom_cam[6], cfg.height_prior_stddev),
            state.heights)
    return state


def _append_history(cfg: MapperConfig, col: SubmapCollection, k: Tensor,
                    T_sm_cams: Tensor, ts: Tensor) -> None:
    """F saturating history appends to submap ``k`` at once, identical to
    F sequential appends: once the history is full every frame writes the
    last entry, so those lanes all carry the LAST frame's values."""
    F = ts.shape[0]
    Hmax = cfg.max_history
    kk = k.reshape(1).long()
    c0 = _row(col.hist_count, k)
    idx = torch.arange(F, device=ts.device)
    h = torch.clamp(c0 + idx, max=Hmax - 1).long()
    src = torch.where(h == Hmax - 1, F - 1, idx)
    kr = kk.expand(F)
    col.hist_stamps.index_put_((kr, h), ts[src])
    col.hist_poses.index_put_((kr, h), T_sm_cams[src])
    col.hist_count.index_copy_(0, kk, torch.clamp(c0 + F, max=Hmax)[None])
    col.end_time.index_copy_(0, kk, ts[F - 1:])


def _integrate_frames(cfg: MapperConfig, state: MapperState,
                      depths: Tensor, colors: Optional[Tensor],
                      T_odom_cams: Tensor, ts: Tensor):
    """Shared body of integrate / integrate_batch (IN PLACE) →
    (n_union, n_dropped) of the window."""
    col = state.collection
    k = col.active
    T_sm_cams = geo.relative(_row(col.T_odom_submap, k)[None], T_odom_cams)
    _, (n_union, n_dropped, touched) = tsdf_ops.integrate_window_stacked_impl(
        cfg.spec, cfg.integrator, cfg.intrinsics, col.layers, k, depths,
        colors, T_sm_cams, return_stats=True)
    _append_history(cfg, col, k, T_sm_cams, ts.to(torch.float32))
    state.frame_count += depths.shape[0]
    kk = k.reshape(1).long()
    state.mesh_dirty.index_copy_(
        0, kk, state.mesh_dirty.index_select(0, kk) | touched[None])
    return n_union, n_dropped


def integrate(cfg: MapperConfig, state: MapperState, depth: Tensor,
              color: Optional[Tensor], T_odom_cam: Tensor,
              t: Tensor) -> MapperState:
    """Integrate one RGB-D frame into the active submap and append to its
    pose history, IN PLACE. (The window counters are integrate_batch's.)"""
    _integrate_frames(cfg, state, depth[None],
                      None if color is None else color[None],
                      T_odom_cam[None], t.reshape(1))
    return state


def integrate_batch(cfg: MapperConfig, state: MapperState, depths: Tensor,
                    colors: Optional[Tensor], T_odom_cams: Tensor,
                    ts: Tensor) -> MapperState:
    """Integrate a window of F frames into the CURRENT active submap, IN
    PLACE; equal to F sequential ``integrate`` calls, plus the window's
    union counters. Submap rollover is the caller's (HostMapper splits
    windows at rollover times).

    depths (F,H,W) f32; colors (F,H,W,3) | (F,3,H,W) | None; T_odom_cams
    (F,7); ts (F,) f32 — all on the state's device. Issues no
    device-to-host read."""
    n_union, n_dropped = _integrate_frames(cfg, state, depths, colors,
                                           T_odom_cams, ts)
    torch.maximum(state.union_watermark, n_union, out=state.union_watermark)
    state.dropped_union_blocks += n_dropped
    return state


def _point_cfg(cfg: MapperConfig) -> points_ops.PointIntegratorConfig:
    if cfg.point_integrator is not None:
        return cfg.point_integrator
    return points_ops.points_cfg_from(cfg.integrator)


def integrate_points(cfg: MapperConfig, state: MapperState, points: Tensor,
                     colors: Optional[Tensor], valid: Tensor,
                     T_odom_sensor: Tensor, t: Tensor) -> MapperState:
    """Integrate one unordered point cloud into the active submap and
    append to its pose history, IN PLACE — the reference client's
    ``pointcloud``-topic input (voxblox integratePointCloud), the mirror
    of ``integrate`` for cloud sensors (lidar, points decoded from a
    mesh). No device-to-host read."""
    col = state.collection
    k = col.active
    T_sm_sensor = geo.relative(_row(col.T_odom_submap, k), T_odom_sensor)
    _, touched = points_ops.integrate_points_stacked_impl(
        cfg.spec, _point_cfg(cfg), col.layers, k, points, colors, valid,
        T_sm_sensor, return_stats=True)
    _append_history(cfg, col, k, T_sm_sensor[None],
                    t.reshape(1).to(torch.float32))
    state.frame_count += 1
    kk = k.reshape(1).long()
    state.mesh_dirty.index_copy_(
        0, kk, state.mesh_dirty.index_select(0, kk) | touched[None])
    return state


def consume_mesh_dirty(state: MapperState, k) -> Tuple[Tensor, MapperState]:
    """Pop submap ``k``'s updated-block bitmap → ((max_blocks,) bool copy,
    state with the row cleared IN PLACE)."""
    kk = torch.as_tensor(k, device=state.mesh_dirty.device).reshape(1).long()
    row = state.mesh_dirty.index_select(0, kk)[0]
    state.mesh_dirty.index_fill_(0, kk, False)
    return row, state


def mapper_step(cfg: MapperConfig, state: MapperState, depth: Tensor,
                color: Optional[Tensor], T_odom_cam: Tensor,
                t: float) -> Tuple[MapperState, bool]:
    """Host-orchestrated step: roll the submap if the interval elapsed,
    then integrate, both IN PLACE → (state, new_submap_started). Reads
    the submap count and the active start time (one device read);
    ``HostMapper.step`` is the read-free form."""
    col = state.collection
    n, start = torch.cat([col.num_submaps.reshape(1).to(torch.float32),
                          _row(col.start_time, col.active).reshape(1)]
                         ).cpu().tolist()
    t_dev = torch.full((), t, dtype=torch.float32, device=depth.device)
    started = False
    if n == 0 or float(t) - start >= cfg.submap_interval - 1e-6:
        start_submap(cfg, state, T_odom_cam, t_dev)
        started = True
    integrate(cfg, state, depth, color, T_odom_cam, t_dev)
    return state, started


class HostMapper:
    """Host-side wrapper that mirrors the rollover scalars (submap count,
    active start time) so the per-frame loop issues ZERO device→host
    reads. ``step`` and ``step_batch`` update ``self.state`` in place.
    Without a state or a device it builds its state on the card
    (``runtime.require_cuda()``); the CPU is used only when asked for."""

    def __init__(self, cfg: MapperConfig,
                 state: Optional[MapperState] = None, device=None):
        # a new state lives on the card unless the caller asks for
        # another device (runtime.require_cuda raises without one)
        self.cfg = cfg
        self.state = state if state is not None else create_mapper(
            cfg, runtime.require_cuda() if device is None else device)
        self.device = self.state.frame_count.device
        self.n_submaps = int(self.state.collection.num_submaps)
        self.last_start = (
            float(self.state.collection.start_time[self.n_submaps - 1])
            if self.n_submaps else 0.0)
        # toggle_mapping service state: frames arriving while disabled
        # are dropped
        self.mapping_enabled = True
        # rollovers refused because the submap pool was full — frames keep
        # integrating into the LAST submap (warn-and-count)
        self.dropped_submaps = 0
        # deferred window-overflow check: step_batch schedules an async
        # host copy of the union counters after each window and consumes
        # it at the next call, so no window waits on a readback
        self._pending_stats = None
        self._warned_dropped = 0
        # schedule/consume the union counters every Nth window (0 = never)
        self.stats_check_windows = 1
        self._windows_done = 0
        # HOST MIRROR of the timeline, submap-frame pose histories and
        # submap poses, kept from host inputs with no device readback.
        # Only valid when it observed every submap from creation.
        self.mirror_enabled = self.n_submaps == 0
        self.host_T_odom_submap: list = []     # per-submap np (7,)
        self.host_submaps: list = []           # {start,end,stamps,poses}
        # per-submap incremental meshers (live_mesh), the submaps that
        # integrated anything since their last live_mesh dispatch, and the
        # odom-frame soups of clean submaps: {k: (pose, verts, colors)}
        self._meshers: dict = {}
        self._touched_submaps: set = set()
        self._odom_soup_cache: dict = {}

    # -- host mirror maintenance ----------------------------------------

    def _mirror_host_pose(self, T_odom_cam):
        """np view of a pose input, or None after DISABLING the mirror:
        device poses would cost a readback per frame to mirror."""
        if isinstance(T_odom_cam, np.ndarray):
            return T_odom_cam
        if self.mirror_enabled:
            self.mirror_enabled = False
            self.host_submaps.clear()
            self.host_T_odom_submap.clear()
        return None

    def _mirror_start(self, T_odom_cam, t: float) -> None:
        if not self.mirror_enabled:
            return
        T = self._mirror_host_pose(T_odom_cam)
        if T is None:
            return
        self.host_T_odom_submap.append(np.asarray(T, np.float32).copy())
        self.host_submaps.append({"start": float(t), "end": float(t),
                                  "stamps": [], "poses": []})

    def _mirror_frame(self, T_odom_cam, t: float) -> None:
        if not self.mirror_enabled or not self.host_submaps:
            return
        T_odom_cam = self._mirror_host_pose(T_odom_cam)
        if T_odom_cam is None:
            return
        k = len(self.host_submaps) - 1
        rec = self.host_submaps[k]
        T_sm_cam = geo.relative_np(self.host_T_odom_submap[k],
                                   np.asarray(T_odom_cam, np.float32))
        if len(rec["stamps"]) >= self.cfg.max_history:
            # saturating append — mirrors the device h-clamp exactly
            rec["stamps"][-1] = float(t)
            rec["poses"][-1] = T_sm_cam
        else:
            rec["stamps"].append(float(t))
            rec["poses"].append(T_sm_cam)
        rec["end"] = float(t)

    def refresh_pose_mirror(self, state: Optional[MapperState] = None
                            ) -> None:
        """Re-read submap poses after a DEVICE-side pose change — one
        whole-buffer readback of (S,7)."""
        if not self.mirror_enabled:
            return
        col = (state or self.state).collection
        T = col.T_odom_submap.cpu().numpy()
        for k in range(min(len(self.host_T_odom_submap), T.shape[0])):
            self.host_T_odom_submap[k] = T[k].copy()

    def apply_pose_updates_host(self, updates) -> None:
        """Mirror server-pushed pose updates (host values — free)."""
        if not self.mirror_enabled:
            return
        for k, T in updates:
            if int(k) < len(self.host_T_odom_submap):
                self.host_T_odom_submap[int(k)] = \
                    np.asarray(T, np.float32).copy()

    # -- saturation and union counters ----------------------------------

    def _rollover_sat(self, n: Optional[int] = None,
                      stacklevel: int = 3) -> bool:
        """True (+warn/count) when a due rollover cannot start a new
        submap because the pool is saturated. ``n`` overrides the live
        submap count (step_batch tracks it locally within a window);
        ``stacklevel`` points the warning at the public step's caller."""
        if (self.n_submaps if n is None else n) < self.cfg.max_submaps:
            return False
        self.dropped_submaps += 1
        warnings.warn(
            f"submap pool saturated ({self.cfg.max_submaps}); rollover "
            f"dropped (total {self.dropped_submaps}) — frames continue "
            f"into the last submap; raise MapperConfig.max_submaps",
            RuntimeWarning, stacklevel=stacklevel)
        return True

    def _warn_overflow(self, wm: int, dropped: int) -> None:
        if dropped > self._warned_dropped:
            warnings.warn(
                f"window working set overflowed: {dropped} block-updates "
                f"dropped (union watermark {wm} > capacity "
                f"{self.cfg.integrator.window_union_blocks}) — raise "
                "TsdfIntegratorConfig.window_union_blocks to at least the "
                "watermark", RuntimeWarning, stacklevel=3)
            self._warned_dropped = dropped

    def _consume_pending_stats(self) -> None:
        """Read the PREVIOUS window's counters (their async copy has
        landed by now) and warn on new drops."""
        if self._pending_stats is None:
            return
        with runtime.span("mapper.stats"):
            host, event = self._pending_stats
            self._pending_stats = None
            if event is not None:
                event.synchronize()
            self._warn_overflow(int(host[0]), int(host[1]))

    def _schedule_stats_check(self) -> None:
        with runtime.span("mapper.stats"):
            pair = torch.stack([self.state.union_watermark,
                                self.state.dropped_union_blocks])
            if pair.is_cuda:
                host = torch.empty(2, dtype=pair.dtype, pin_memory=True)
                host.copy_(pair, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = pair.clone(), None
            self._pending_stats = (host, event)

    def union_saturation(self) -> Tuple[int, int]:
        """Host readback of (union_watermark, dropped_union_blocks); warns
        when updates have been dropped. Call at control rate."""
        self._pending_stats = None
        wm = int(self.state.union_watermark)
        dropped = int(self.state.dropped_union_blocks)
        self._warn_overflow(wm, dropped)
        return wm, dropped

    # -- frames ----------------------------------------------------------

    def _tensor(self, x) -> Tensor:
        """A frame input on the mapper's device as f32 (no copy if it is
        already there)."""
        if isinstance(x, Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(
            self.device, non_blocking=True)

    def _maybe_roll(self, T_odom, T_dev: Tensor, t: float,
                    t_dev: Tensor) -> bool:
        """Start a submap at pose ``T_odom`` if there is none yet or the
        active one's interval elapsed (a saturated pool keeps the active
        one) → whether one was started."""
        if (self.n_submaps > 0
                and t - self.last_start < self.cfg.submap_interval - 1e-6):
            return False
        self.last_start = t
        if self._rollover_sat(stacklevel=4):
            return False
        with runtime.span("mapper.start_submap"):
            start_submap(self.cfg, self.state, T_dev, t_dev)
        self.n_submaps += 1
        self._mirror_start(T_odom, t)
        return True

    def step(self, depth, color, T_odom_cam, t: float) -> bool:
        """Roll the submap if its interval elapsed, then integrate one
        frame. Returns whether a submap was started."""
        if not self.mapping_enabled:
            return False
        with runtime.span("mapper.step"):
            self._consume_pending_stats()
            with runtime.span("mapper.upload"):
                T_dev = self._tensor(T_odom_cam)
                t_dev = torch.full((), t, dtype=torch.float32,
                                   device=self.device)
                depth = self._tensor(depth)
                color = None if color is None else self._tensor(color)
            started = self._maybe_roll(T_odom_cam, T_dev, t, t_dev)
            integrate(self.cfg, self.state, depth, color, T_dev, t_dev)
            with runtime.span("mapper.mirror"):
                self._mirror_frame(T_odom_cam, t)
            self._touched_submaps.add(max(self.n_submaps - 1, 0))
        runtime.count("mapper.frames")
        runtime.count("mapper.rollovers", int(started))
        return started

    def step_points(self, points, colors, valid, T_odom_sensor,
                    t: float) -> bool:
        """Point-cloud sensor step (lidar, recovered clouds): the rollover
        of ``step``, then ``integrate_points``. Returns whether a submap
        was started."""
        if not self.mapping_enabled:
            return False
        self._consume_pending_stats()
        T_dev = self._tensor(T_odom_sensor)
        t_dev = torch.full((), t, dtype=torch.float32, device=self.device)
        started = self._maybe_roll(T_odom_sensor, T_dev, t, t_dev)
        valid = (valid.to(self.device, torch.bool)
                 if isinstance(valid, Tensor)
                 else torch.from_numpy(np.asarray(valid, bool)).to(
                     self.device, non_blocking=True))
        integrate_points(self.cfg, self.state, self._tensor(points),
                         None if colors is None else self._tensor(colors),
                         valid, T_dev, t_dev)
        self._mirror_frame(T_odom_sensor, t)
        self._touched_submaps.add(max(self.n_submaps - 1, 0))
        return started

    def step_batch(self, depths, colors, T_odom_cams, ts) -> int:
        """Process a window of F frames: rollover boundaries are computed
        on the host from the timestamps (no device read), and the frames
        between boundaries go through one integrate_batch each. Equal to F
        step() calls. Returns the number of submaps started."""
        if not self.mapping_enabled:
            return 0
        with runtime.span("mapper.step_batch"):
            self._consume_pending_stats()   # previous window's counters
            with runtime.span("mapper.rollover_plan"):
                # poses for the mirror — host arrays only (a device input
                # disables the mirror rather than paying a readback per
                # window)
                T_host = (self._mirror_host_pose(T_odom_cams)
                          if self.mirror_enabled else None)
                # rollover bookkeeping in FLOAT64: an f32 downcast loses
                # ~4 µs of resolution per minute of mission time, so `t -
                # last_start >= interval - 1e-6` would start failing at
                # exact window boundaries and fire a rollover one frame
                # late; the device still gets f32
                ts = np.asarray(ts, np.float64)
                F = len(ts)
                starts = []          # frame indices where a rollover fires
                last = self.last_start
                n = self.n_submaps
                interval = self.cfg.submap_interval - 1e-6
                for i in range(F):
                    if n == 0 or ts[i] - last >= interval:
                        last = float(ts[i])
                        # saturated: warn+count, frames go to the last
                        # submap
                        if not self._rollover_sat(n):
                            starts.append(i)
                            n += 1
                segments = []        # (rollover frame or None, lo, hi)
                if not starts or starts[0] > 0:
                    segments.append((None, 0, starts[0] if starts else F))
                bounds = starts + [F]
                for b, e in zip(bounds[:-1], bounds[1:]):
                    segments.append((b, b, e))

            with runtime.span("mapper.upload"):
                depths = self._tensor(depths)
                colors = None if colors is None else self._tensor(colors)
                T_dev = self._tensor(T_odom_cams)
                ts_dev = self._tensor(ts)
            for start_i, lo, hi in segments:
                if start_i is not None:
                    with runtime.span("mapper.start_submap"):
                        start_submap(self.cfg, self.state, T_dev[start_i],
                                     ts_dev[start_i])
                    self.n_submaps = min(self.n_submaps + 1,
                                         self.cfg.max_submaps)
                    self.last_start = float(ts[start_i])
                    if T_host is not None:
                        self._mirror_start(T_host[start_i], float(ts[start_i]))
                if hi > lo:
                    integrate_batch(self.cfg, self.state, depths[lo:hi],
                                    None if colors is None else colors[lo:hi],
                                    T_dev[lo:hi], ts_dev[lo:hi])
                    self._touched_submaps.add(max(self.n_submaps - 1, 0))
                    if T_host is not None:
                        with runtime.span("mapper.mirror"):
                            for i in range(lo, hi):
                                self._mirror_frame(T_host[i], float(ts[i]))
            # persist the interval clock even when the last rollover(s) were
            # saturation-DROPPED, so _rollover_sat fires once per interval
            self.last_start = last
            self._windows_done += 1
            if (self.stats_check_windows > 0
                    and self._windows_done % self.stats_check_windows == 0):
                self._schedule_stats_check()
            runtime.count("mapper.frames", F)
            runtime.count("mapper.rollovers", len(starts))
            return len(starts)

    def finish_map(self, solver_cfg: Optional[pg.SolverConfig] = None
                   ) -> None:
        """Final local PGO, then stop integrating (the reference's
        finish_map service)."""
        self._consume_pending_stats()
        if self.n_submaps > 1:
            optimize_local(self.cfg, self.state, solver_cfg)
            self.refresh_pose_mirror()
        self.union_saturation()
        self.mapping_enabled = False

    # -- live meshing -----------------------------------------------------

    _MESHER_KWARGS = ("chunk", "min_weight", "max_tris", "quantize")

    def live_mesher(self, k: int, **kwargs) -> IncrementalMesher:
        """The incremental mesher of submap ``k`` (created on first use
        with ``kwargs``). Settings are fixed at creation: a kwarg that
        conflicts with the existing mesher raises (except ``max_tris``,
        which grows), an unknown kwarg raises, no kwargs accepts it."""
        unknown = set(kwargs) - set(self._MESHER_KWARGS)
        if unknown:
            raise TypeError(f"live_mesher: unknown kwargs {sorted(unknown)}")
        m = self._meshers.get(k)
        if m is None:
            m = IncrementalMesher(self.cfg.spec, **kwargs)
            self._meshers[k] = m
            return m
        for key, val in kwargs.items():
            if key != "max_tris" and getattr(m, key) != val:
                raise ValueError(
                    f"live_mesher({k}) already exists with "
                    f"{key}={getattr(m, key)!r}; requested {val!r} — "
                    "per-submap mesher settings are fixed at creation")
        return m

    def live_mesh(self, k: Optional[int] = None, **kwargs):
        """Up-to-date triangle soup of submap ``k`` (default: active) in
        the SUBMAP frame, re-meshing only the blocks updated since the
        last call → (verts (T,3,3), colors (T,3,3)) f32 numpy."""
        return self.live_mesh_async(k, **kwargs)()

    def live_mesh_async(self, k: Optional[int] = None, **kwargs):
        """Dispatch half of :meth:`live_mesh` for pipelined serving:
        consume submap ``k``'s dirty bits and copy its layer, then return
        a zero-argument ``finish()`` that re-meshes and returns the soup.
        ``finish()`` meshes the geometry as of dispatch, even after later
        ``step_batch`` calls (``get_layer`` copies). Call ``finish()`` from
        one serving thread only.

        The consumed row stays pending on the mesher until a ``finish()``
        has used it, and each dispatch ORs the pending row in, so a
        dispatch whose ``finish()`` never runs loses no update. The
        mesher's settings are checked before anything is consumed."""
        if k is None:
            k = max(self.n_submaps - 1, 0)
        mesher = self.live_mesher(k, **kwargs)
        self._consume_pending_stats()
        with runtime.span("serve.consume_dirty"):
            row, _ = consume_mesh_dirty(self.state, k)
            if mesher.pending is not None:
                row = row | mesher.pending
            mesher.pending = row
            layer = get_layer(self.state.collection.layers, k)
        self._touched_submaps.discard(k)

        def finish():
            mesher.update(layer, row)
            if mesher.pending is row:
                mesher.pending = None
            return mesher.mesh()

        return finish

    def live_mesh_odom(self, **kwargs):
        """All submaps' live meshes concatenated in the ODOM frame (one
        incremental update per submap that changed) → (verts (T,3,3),
        colors (T,3,3))."""
        poses = self.state.collection.T_odom_submap.cpu().numpy()
        vs, cs = [], []
        for k in range(self.n_submaps):
            m = self._meshers.get(k)
            clean = (m is not None and m.pending is None
                     and k not in self._touched_submaps)
            cached = self._odom_soup_cache.get(k)
            if clean and cached is not None \
                    and np.array_equal(cached[0], poses[k]):
                # unchanged geometry at an unchanged pose
                vs.append(cached[1])
                cs.append(cached[2])
                continue
            if clean:
                # geometry current, pose moved: re-transform the cache
                v, c = self.live_mesher(k, **kwargs).mesh()
            else:
                v, c = self.live_mesh(k, **kwargs)
            if v.shape[0] == 0:
                self._odom_soup_cache.pop(k, None)
                continue
            vw = geo.transform_points_np(
                poses[k], v.reshape(-1, 3)).reshape(-1, 3, 3)
            vw = vw.astype(np.float32)
            self._odom_soup_cache[k] = (poses[k].copy(), vw, c)
            vs.append(vw)
            cs.append(c)
        if not vs:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z.copy()
        return np.concatenate(vs), np.concatenate(cs)


def optimize_local(cfg: MapperConfig, state: MapperState,
                   solver_cfg: Optional[pg.SolverConfig] = None
                   ) -> MapperState:
    """Run the local pose graph over the submap poses (odometry chain,
    added loop closures, and the height priors when
    ``cfg.height_prior_stddev > 0``) and write the optimized poses IN
    PLACE. ``solver_cfg`` defaults to ``cfg.local_solver``, then to
    ``pg.SolverConfig()``. No device-to-host read."""
    if solver_cfg is None:
        solver_cfg = cfg.local_solver or pg.SolverConfig()
    col = state.collection
    with runtime.span("mapper.optimize_local"):
        res = pg.optimize(col.T_odom_submap, state.constraints, solver_cfg,
                          heights=(state.heights
                                   if cfg.height_prior_stddev > 0 else None))
        col.T_odom_submap.copy_(res.poses)
    return state


def add_loop_closure(state: MapperState, i, j, T_i_j: Tensor,
                     sqrt_info: Optional[Tensor] = None) -> MapperState:
    """Add an intra-robot loop-closure constraint between submaps i and
    j to the local pose graph (replaces ``state.constraints``)."""
    state.constraints = state.constraints.add(i, j, T_i_j, sqrt_info)
    return state


def _composed_histories(T_odom_submap: Tensor, hist_poses: Tensor
                        ) -> Tensor:
    """(S,7)×(S,H,7) → (S,H,7) odom-frame poses in one batched compose."""
    return geo.compose(T_odom_submap[:, None, :], hist_poses)


def trajectory(col: SubmapCollection) -> Tuple[Tensor, Tensor]:
    """Full odom-frame trajectory (stamps (N,), poses (N,7)) on the
    collection's device: the per-submap histories re-posed by the
    (possibly optimized) submap poses, in submap order. One read of the
    history counts."""
    device = col.hist_stamps.device
    counts = torch.cat([col.hist_count,
                        col.num_submaps.reshape(1)]).cpu().numpy()
    n = int(counts[-1])
    keep = np.zeros(col.hist_stamps.shape, bool)
    for k in range(n):
        keep[k, :counts[k]] = True
    if not keep.any():
        return (torch.zeros((0,), device=device),
                torch.zeros((0, 7), device=device))
    sel = torch.from_numpy(np.flatnonzero(keep)).to(device)
    poses = _composed_histories(col.T_odom_submap, col.hist_poses)
    return (col.hist_stamps.reshape(-1).index_select(0, sel),
            poses.reshape(-1, 7).index_select(0, sel))


def merged_layer(cfg: MapperConfig, col: SubmapCollection,
                 growth_cap: int = 4) -> vx.TsdfLayer:
    """Fuse all submaps into one odom-frame TSDF layer on the collection's
    device. The target pool grows to the next power of two above the
    summed live-block count (an upper bound of the union), capped at
    ``growth_cap`` × the configured pool and at the grid's cells."""
    spec = cfg.spec
    n = int(col.num_submaps)
    if growth_cap > 0 and n:
        total = int(col.layers.num_blocks[:n].sum())
        if total > spec.max_blocks:
            need = min(1 << (total - 1).bit_length(),
                       growth_cap * spec.max_blocks, spec.grid_dim ** 3)
            if need > spec.max_blocks:
                spec = dataclasses.replace(spec, max_blocks=need)
    merged = vx.create_tsdf_layer(spec, col.layers.sdf.device)
    for k in range(n):
        merge_ops.merge_layer_into_sized(
            spec, merged, get_layer(col.layers, k), col.T_odom_submap[k],
            src_spec=cfg.spec if spec != cfg.spec else None)
    return merged
