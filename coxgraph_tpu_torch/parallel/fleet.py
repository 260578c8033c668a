"""Multi-robot SPMD over a process group — port of
``coxgraph_tpu.parallel.fleet`` (the reference's per-robot ROS processes,
launch/cvg/run_experiment_cvg.launch:5-7, and its central Ceres solve,
backend/pose_graph.h:52-73).

Design:
  * a fleet is a list of per-robot ``MapperState``s; each rank of the
    ``RobotMesh`` holds ``per_rank`` consecutive robots (``Fleet``). The
    JAX package stacks the states along a leading ``robot`` axis; the port
    keeps them apart because its mapper updates pools in place but
    reassigns ``constraints`` / ``heights``, which a view into a stacked
    state would lose. ``utils.interop`` reads and writes the stacked
    ``(R, …)`` layout;
  * dense integration runs robot by robot on each rank (``fleet_step``):
    the rollover decision stays a device mask, so a step issues no host
    read, and each robot's frame is one K1 launch on the card;
  * the global pose-graph solve is a distributed LM (``fleet_optimize``):
    each rank builds the normal equations of its robots' constraints
    against the replicated pose vector, H and b are summed over the ranks
    in one ``all_reduce``, the replicated inter-robot constraints are
    added once after the reduction, and the damped Cholesky solve and
    accept/reject run replicated on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import runtime
from ..mapper import submap_mapper as sm
from ..solver import pose_graph as pg
from .collectives import RobotMesh, gather_rows, psum

Tensor = torch.Tensor


@dataclasses.dataclass
class Fleet:
    """This rank's robots of an ``n_robots`` fleet: ``states[i]`` is robot
    ``first + i``."""

    states: List[sm.MapperState]
    first: int
    n_robots: int


def make_robot_mesh(n_robots: Optional[int] = None, device=None,
                    group=None) -> RobotMesh:
    """The mesh over an initialized process group (``group``; None: the
    default group, see ``multihost.initialize``) holding ``n_robots``
    (default: one a rank). ``device`` None: this process's card
    (``runtime.require_cuda``); the CPU only when asked for."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize or "
                           "multihost.single_process first")
    world = dist.get_world_size(group)
    n = n_robots or world
    if n % world:
        raise ValueError(f"{n} robots do not split over {world} ranks")
    if device is None:
        runtime.require_cuda()
        device = torch.device("cuda", torch.cuda.current_device())
    return RobotMesh(group=group, rank=dist.get_rank(group), world=world,
                     device=torch.device(device), per_rank=n // world)


def _moved(obj, device):
    """A dataclass tree of tensors on ``device`` (shared where it is
    already there)."""
    return type(obj)(**{
        f.name: (_moved(v, device) if dataclasses.is_dataclass(v)
                 else v.to(device))
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)})


def create_fleet(cfg: sm.MapperConfig, n_robots: int, device) -> Fleet:
    """Every robot's fresh mapper state on ``device``."""
    return Fleet(states=[sm.create_mapper(cfg, device)
                         for _ in range(n_robots)],
                 first=0, n_robots=n_robots)


def shard_fleet(fleet: Fleet, mesh: RobotMesh) -> Fleet:
    """This rank's robots of a whole fleet, on ``mesh.device``."""
    if fleet.n_robots != mesh.n_robots or fleet.first != 0 or \
            len(fleet.states) != fleet.n_robots:
        raise ValueError("shard_fleet takes a whole fleet of the mesh's "
                         f"{mesh.n_robots} robots")
    rows = mesh.share(fleet.n_robots)
    return Fleet(states=[_moved(fleet.states[r], mesh.device) for r in rows],
                 first=rows.start, n_robots=fleet.n_robots)


def robot_state(fleet: Fleet, r: int) -> sm.MapperState:
    """Robot ``r``'s state (a robot this rank holds)."""
    if not fleet.first <= r < fleet.first + len(fleet.states):
        raise IndexError(f"robot {r} is not held by this rank")
    return fleet.states[r - fleet.first]


def fleet_step(cfg: sm.MapperConfig, mesh: RobotMesh, fleet: Fleet,
               depths: Tensor, colors: Optional[Tensor],
               T_odom_cams: Tensor, ts: Tensor) -> Fleet:
    """One fleet step, IN PLACE: each robot rolls its submap over when it
    has none or its interval elapsed (a device mask), then integrates its
    frame. Inputs are the whole fleet's — depths (R,H,W), colors (R,H,W,3)
    or None, T_odom_cams (R,7), ts (R,) f32, on ``mesh.device`` — and each
    rank reads its robots' rows. Issues no device-to-host read.

    The rollover records no height prior, whatever
    ``cfg.height_prior_stddev``: the JAX fleet records none and
    ``fleet_optimize`` solves with none, so every field of a robot's state,
    ``heights`` included, equals the JAX fleet's."""
    for i, state in enumerate(fleet.states):
        r = fleet.first + i
        t, T = ts[r], T_odom_cams[r]
        col = state.collection
        n = col.num_submaps
        start = sm._row(col.start_time, torch.clamp(n - 1, min=0))
        go = (n == 0) | (t - start >= cfg.submap_interval - 1e-6)
        sm.start_submap(cfg, state, T, t, go=go, height_prior=False)
        sm.integrate(cfg, state, depths[r],
                     None if colors is None else colors[r], T, t)
    return fleet


def globalize_constraints(c: pg.RelPoseConstraints, robot: int,
                          max_submaps: int) -> pg.RelPoseConstraints:
    """Robot ``robot``'s constraint pool re-indexed into the global pose
    vector: (robot r, submap s) → r·S + s."""
    off = robot * max_submaps
    return dataclasses.replace(c, i=c.i + off, j=c.j + off)


def fleet_optimize(cfg: sm.MapperConfig, mesh: RobotMesh, fleet: Fleet,
                   inter_robot: pg.RelPoseConstraints,
                   solver_cfg: pg.SolverConfig = pg.SolverConfig(),
                   ) -> Tuple[Fleet, Tensor]:
    """Distributed LM over all robots' submap poses (R·S global poses).

    ``inter_robot``: a pool on ``mesh.device``, the same on every rank,
    whose indices are already global — the map-fusion constraints of the
    reference server (coxgraph_server.cpp:449-467). Updates this rank's
    robots' T_odom_submap IN PLACE → (fleet, global poses (R·S,7)).

    Per iteration one ``all_reduce`` of [H | b] and one gather of the new
    poses' cost per robot; no device-to-host read. Each robot's normal
    equations and cost are its own (its constraints touch only its own
    poses), summed in robot order: the ranks' sums then add entries that
    only one rank holds, so every rank and every world size take the same
    steps from the same robots bit for bit (a reduction over all of a
    rank's constraints would round by the rank's share, and near the
    minimum a step may change the cost by less than that rounding). Each
    robot's normal equations carry the fixed poses' unit diagonal, so
    with the inter-robot part it is R + 1 (the JAX package's devices + 1);
    those rows and columns are otherwise zero and b is zero there, so δ = 0
    either way."""
    R, S = fleet.n_robots, cfg.max_submaps
    N = R * S
    d = 6 * N
    parts = [globalize_constraints(st.constraints, fleet.first + i, S)
             for i, st in enumerate(fleet.states)]
    inter = inter_robot
    # poses some valid constraint references, on any rank
    touched = psum(mesh, sum(pg.touched_poses(N, c).to(torch.int32)
                             for c in parts)) > 0
    fixed = (pg.default_fixed(N, mesh.device) | ~(
        touched | pg.touched_poses(N, inter)))

    def normal_eq(poses):
        Hb = 0
        for c in parts:
            H, b, _ = pg._build_normal_equations(poses, c, solver_cfg, fixed)
            Hb = Hb + torch.cat([H.reshape(-1), b])
        return psum(mesh, Hb)

    def cost(poses):
        mine = torch.stack([pg._total_cost(poses, c, solver_cfg)
                            for c in parts])
        return (gather_rows(mesh, mine, R, fleet.first).sum()
                + pg._total_cost(poses, inter, solver_cfg))

    mine = torch.stack([st.collection.T_odom_submap for st in fleet.states])
    poses = gather_rows(mesh, mine, R, fleet.first).reshape(N, 7)
    cur = cost(poses)
    lam = torch.full((), solver_cfg.damping_init, dtype=poses.dtype,
                     device=poses.device)
    for _ in range(solver_cfg.iterations):
        Hb = normal_eq(poses)
        Hi, bi, _ = pg._build_normal_equations(poses, inter, solver_cfg,
                                               fixed)
        delta = pg.damped_solve(Hb[:d * d].reshape(d, d) + Hi,
                                Hb[d * d:] + bi, lam)
        new_poses = pg._apply_delta(poses, delta, solver_cfg)
        new = cost(new_poses)
        accept = new < cur
        poses = torch.where(accept, new_poses, poses)
        cur = torch.where(accept, new, cur)
        lam = pg.lm_update(accept, lam, solver_cfg)

    out = poses.reshape(R, S, 7)
    for i, st in enumerate(fleet.states):
        st.collection.T_odom_submap.copy_(out[fleet.first + i])
    return fleet, poses


def ici_bytes_per_optimize(cfg: sm.MapperConfig, n_robots: int,
                           solver_cfg: pg.SolverConfig = pg.SolverConfig(),
                           ) -> dict:
    """Static traffic accounting for one fleet_optimize call (the
    exchange-layer byte counters of SURVEY.md §5.1/§5.8): per LM
    iteration each device reduces H (6N·6N f32) + b (6N) + the scalar
    cost over the robot axis, after one initial all-gather of the pose
    pool (N·7 f32). Counts are the logical reduced payload per device; a
    ring all-reduce moves ≈2·(n-1)/n of that on the wire."""
    N = n_robots * cfg.max_submaps
    d = 6 * N
    per_iter = (d * d + d + 1) * 4
    return {
        "n_iterations": solver_cfg.iterations,
        "all_gather_bytes": N * 7 * 4,
        "per_iteration_bytes": per_iter,
        "per_device_bytes": N * 7 * 4 + solver_cfg.iterations * per_iter,
    }
