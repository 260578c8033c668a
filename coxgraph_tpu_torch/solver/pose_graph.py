"""Pose-graph constraint pools — the part of
``coxgraph_tpu.solver.pose_graph`` that the mapper's integration path
carries. ``start_submap`` chains one relative-pose constraint per new
submap and, when configured, one height prior.

Both pools are fixed-capacity with validity masks. ``add`` past capacity
drops the row but still advances ``count`` — an unclamped insertion
watermark, so ``num_dropped`` makes saturation observable. ``add`` is
functional (returns a new pool); the pools are small.

The Levenberg-Marquardt solve is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import geometry as geo
from ..utils.tensorops import put_row

Tensor = torch.Tensor


def _cloned(obj):
    return type(obj)(**{f.name: getattr(obj, f.name).clone()
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class RelPoseConstraints:
    """Fixed-capacity pool of relative-pose constraints
    r = sqrt_info · log(T_meas⁻¹ · T_i⁻¹ · T_j)."""

    i: Tensor          # (M,) int32
    j: Tensor          # (M,) int32
    T_meas: Tensor     # (M,7)
    sqrt_info: Tensor  # (M,6,6)
    valid: Tensor      # (M,) bool
    count: Tensor      # () int32 — insertion watermark

    @staticmethod
    def empty(capacity: int, device) -> "RelPoseConstraints":
        return RelPoseConstraints(
            i=torch.zeros((capacity,), dtype=torch.int32, device=device),
            j=torch.zeros((capacity,), dtype=torch.int32, device=device),
            T_meas=geo.identity(device)[None].repeat(capacity, 1),
            sqrt_info=torch.eye(6, device=device)[None].repeat(
                capacity, 1, 1),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def add(self, i, j, T_meas: Tensor, sqrt_info=None
            ) -> "RelPoseConstraints":
        """Append one constraint (``i``/``j`` ints or 0-d device tensors).
        Past capacity the row is dropped but ``count`` keeps advancing."""
        out = _cloned(self)
        k = self.count
        si = (torch.eye(6, device=T_meas.device) if sqrt_info is None
              else sqrt_info)
        put_row(out.i, k, i)
        put_row(out.j, k, j)
        put_row(out.T_meas, k, T_meas)
        put_row(out.sqrt_info, k, si)
        put_row(out.valid, k, True)
        out.count = k + 1
        return out

    @property
    def capacity(self) -> int:
        return self.i.shape[0]

    def num_dropped(self) -> int:
        """Constraints lost to pool overflow (one host readback)."""
        return max(0, int(self.count) - self.capacity)


@dataclasses.dataclass
class HeightConstraints:
    """Fixed-capacity pool of absolute height priors
    r = (1/stddev) · (position_z(T_i) - height)."""

    i: Tensor           # (M,) int32
    height: Tensor      # (M,)
    info: Tensor        # (M,)  1/stddev whitening weight
    valid: Tensor       # (M,) bool
    count: Tensor       # () int32

    @staticmethod
    def empty(capacity: int, device) -> "HeightConstraints":
        return HeightConstraints(
            i=torch.zeros((capacity,), dtype=torch.int32, device=device),
            height=torch.zeros((capacity,), device=device),
            info=torch.ones((capacity,), device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def add(self, i, height, stddev: float = 1.0) -> "HeightConstraints":
        """Append one height prior (unclamped ``count`` watermark past
        capacity — see RelPoseConstraints.add)."""
        out = _cloned(self)
        k = self.count
        put_row(out.i, k, i)
        put_row(out.height, k, height)
        put_row(out.info, k, 1.0 / stddev)
        put_row(out.valid, k, True)
        out.count = k + 1
        return out

    @property
    def capacity(self) -> int:
        return self.i.shape[0]

    def num_dropped(self) -> int:
        """Priors lost to pool overflow (one host readback)."""
        return max(0, int(self.count) - self.capacity)
