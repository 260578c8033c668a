"""The parallel tier's process mesh and its collectives — the port's
counterpart of a 1-D ``Mesh(('robot',))`` with ``psum``, ``all_gather``
and ``ppermute`` under ``shard_map``.

A JAX mesh runs one program per device; here one process runs per rank
of a ``torch.distributed`` process group, holds its share of the robots
(slabs, submaps, pool slots) and loops over them. With world size 1 one
process holds everything (one card, NCCL).

Every collective is an ``all_reduce`` (sum). gloo lists only
``broadcast`` and ``all_reduce`` for CUDA tensors, and two ranks on one
card need gloo (NCCL refuses two ranks on one GPU):

* ``psum`` is an ``all_reduce`` of a copy;
* ``gather_rows`` (``all_gather``) is an ``all_reduce`` over a
  zero-padded buffer in which each rank writes its own rows;
* a neighbour exchange (``ppermute``) is such a gather from which each
  rank reads its neighbours' rows.

A collective goes through the group's backend or raises; nothing is
copied to the host to get round a backend. Each call adds the bytes it
hands to the backend to ``RobotMesh.payload`` under its kind
("all_reduce" or "all_gather").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RobotMesh:
    """One rank's view of the process group the parallel tier runs on."""

    group: Optional[object]       # the process group (None: the default)
    rank: int
    world: int
    device: torch.device          # where this rank's tensors live
    per_rank: int                 # robots held by each rank
    # bytes handed to the backend so far, by kind (see module docstring)
    payload: Dict[str, int] = dataclasses.field(default_factory=dict,
                                                compare=False)

    @property
    def n_robots(self) -> int:
        return self.world * self.per_rank

    def share(self, n: int) -> range:
        """The items of ``n`` this rank holds: ⌈n / world⌉ a rank, in rank
        order (the last ranks may hold fewer or none)."""
        per = -(-n // self.world)
        return range(min(self.rank * per, n), min((self.rank + 1) * per, n))


def _count(mesh: RobotMesh, kind: str, t: Tensor) -> None:
    mesh.payload[kind] = (mesh.payload.get(kind, 0)
                          + t.numel() * t.element_size())


def psum(mesh: RobotMesh, x: Tensor) -> Tensor:
    """The sum of ``x`` over the ranks (a new tensor)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group)
    _count(mesh, "all_reduce", out)
    return out


def gather_rows(mesh: RobotMesh, local: Tensor, n: int,
                start: Optional[int] = None) -> Tensor:
    """The (n, …) array whose rows ``[start, start + len(local))`` each
    rank holds in ``local``; ``start`` defaults to ``mesh.share(n).start``.
    The ranks' row ranges must not overlap."""
    if start is None:
        start = mesh.share(n).start
    buf = local.new_zeros((n,) + tuple(local.shape[1:]))
    buf[start:start + local.shape[0]] = local
    dist.all_reduce(buf, group=mesh.group)
    _count(mesh, "all_gather", buf)
    return buf
