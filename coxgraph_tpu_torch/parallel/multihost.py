"""Multi-process bring-up — port of ``coxgraph_tpu.parallel.multihost``
(the host half of SURVEY.md §5.8's two-tier fabric): ``initialize``
joins this process to a ``torch.distributed`` process group, so the
programs of ``fleet.py`` / ``esdf_sharded.py`` / ``merge_sharded.py`` span
processes and hosts (NCCL between cards, gloo between CPU processes).

Bring-up (per process):

    from coxgraph_tpu_torch.parallel import fleet as fl, multihost
    device = multihost.initialize("10.0.0.1:9911", num_processes=2,
                                  process_id=k)
    mesh = multihost.global_robot_mesh(n_robots)
    fleet = interop.fleet_from_numpy(arrays, device, mesh)
    fleet, poses = fl.fleet_optimize(cfg, mesh, fleet, inter)

Every rank passes the same host arrays (built from a shared seed) and
keeps the rows it owns (``make_global_pytree``), or all of them
(``replicate``). ``single_process`` is the world-1 group one process
needs to run the same programs alone.

The JAX package counts a solve's collective bytes by parsing the compiled
HLO; here ``fleet_optimize_comm_bytes`` runs the solve and reads the
bytes the collectives themselves counted (``RobotMesh.payload``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue as queue_mod
import socket
import tempfile
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..utils.tensorops import host
from .collectives import RobotMesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None,
               backend: Optional[str] = None) -> torch.device:
    """Join this process to a ``num_processes`` group as rank
    ``process_id``, meeting at ``coordinator_address`` ("host:port", or an
    init URL such as "file:///path") → this process's device.

    Default: NCCL on ``cuda:{process_id mod the visible cards}``.
    ``device`` "cpu" uses gloo (the CPU bring-up and the tests). ``backend``
    overrides the choice: gloo for ranks that share one card (NCCL refuses
    two ranks on one GPU)."""
    if device is None:
        runtime.require_cuda()
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return device


@contextlib.contextmanager
def single_process(device, backend: Optional[str] = None):
    """A world-size-1 group for this process (a FileStore in a temporary
    directory), destroyed on exit → the device. NCCL on a card, gloo on
    the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        dev = initialize("file://" + os.path.join(tmp, "store"), 1, 0,
                         device, backend)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _rank_main(rank, world, port, device, backend, fn, args, out) -> None:
    """One spawned rank of ``spawn``."""
    try:
        initialize(f"127.0.0.1:{port}", world, rank, device, backend)
        out.put((rank, True, fn(*args)))
    except Exception:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


SPAWN_TIMEOUT_S = 600.0     # a rank's whole run, start-up included


def spawn(fn, world: int, args=(), device=None,
          backend: Optional[str] = None) -> list:
    """Run ``fn(*args)`` in ``world`` spawned processes, ranks of one group
    that meets at a free localhost port (``initialize``'s ``device`` and
    ``backend``) → their results in rank order. ``fn`` and ``args`` are
    pickled, so ``fn`` must be importable by module path. Raises with a
    failing rank's traceback; stops every process it started."""
    import multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, device,
                                                  backend, fn, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, ok, val = out.get(timeout=SPAWN_TIMEOUT_S)
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
    except queue_mod.Empty:
        errors.append(f"no result within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a spawned rank failed: " + "\n".join(errors))
    return [results[r] for r in range(world)]


def global_robot_mesh(n_robots: Optional[int] = None,
                      device=None) -> RobotMesh:
    """The mesh over every process of the default group: a rank's
    collectives cross processes and hosts."""
    from .fleet import make_robot_mesh
    return make_robot_mesh(n_robots, device)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(host(a))).to(device)


def make_global_array(shape, mesh: RobotMesh,
                      fill: Callable[[slice], np.ndarray]) -> torch.Tensor:
    """This rank's rows of a global array of ``shape`` split along its
    leading axis (``mesh.share``): every rank calls this with the same
    arguments; ``fill(rows)`` returns the numpy data of a row slice."""
    r = mesh.share(shape[0])
    return _tensor(fill(slice(r.start, r.stop)), mesh.device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree)


def make_global_pytree(template, mesh: RobotMesh):
    """A dict or dataclass tree of arrays split along their leading axis:
    every rank passes the same host tree (from a shared seed) and keeps
    the rows it owns, on ``mesh.device``."""
    def leaf(x):
        a = host(x)
        return make_global_array(a.shape, mesh, lambda rows: a[rows])
    return _tree_map(leaf, template)


def replicate(x, mesh: RobotMesh):
    """A host-identical tree (every rank holds the same values — e.g. the
    inter-robot constraints built from shared data) on ``mesh.device``."""
    return _tree_map(lambda a: _tensor(a, mesh.device), x)


def fleet_optimize_comm_bytes(cfg, mesh: RobotMesh, fleet, inter_robot,
                              solver_cfg) -> dict:
    """The collective payload of one ``fleet.fleet_optimize`` on this mesh
    → {"per_iteration": {kind: bytes}, "setup": {kind: bytes},
    "per_optimize": total bytes}, counted by running the solve with 0 and
    with ``solver_cfg.iterations`` iterations (the fleet's poses are put
    back afterwards).

    Relation to ``fleet.ici_bytes_per_optimize`` (N poses of R robots):
    per_iteration is {"all_reduce": per_iteration_bytes − 4 ([H | b]),
    "all_gather": R·4 (the new cost, one f32 a robot)}; setup is
    {"all_gather": all_gather_bytes + R·4 (the pose vector, N·7 f32, and
    the start cost), "all_reduce": N·4 (the touched-pose mask, int32)};
    so per_optimize = per_device_bytes + N·4 + (iterations + 1)·(R·4) −
    iterations·4."""
    from . import fleet as fl

    saved = [st.collection.T_odom_submap.clone() for st in fleet.states]
    counts = []
    for iters in (0, solver_cfg.iterations):
        before = dict(mesh.payload)
        fl.fleet_optimize(cfg, mesh, fleet, inter_robot,
                          dataclasses.replace(solver_cfg, iterations=iters))
        counts.append({k: v - before.get(k, 0)
                       for k, v in mesh.payload.items()})
        for st, T in zip(fleet.states, saved):
            st.collection.T_odom_submap.copy_(T)
    setup, total = counts
    n = max(solver_cfg.iterations, 1)
    per_iter = {k: (v - setup.get(k, 0)) // n for k, v in total.items()
                if v - setup.get(k, 0)}
    return {"per_iteration": per_iter,
            "setup": {k: v for k, v in setup.items() if v},
            "per_optimize": sum(total.values())}
