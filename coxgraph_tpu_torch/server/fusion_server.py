"""The fusion server's message types — port of the parts of
``coxgraph_tpu.server.fusion_server`` that the loop detector emits. The
server itself is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MapFusionMsg:
    """Inter-robot loop closure (coxgraph_msgs/MapFusion.msg:1-6):
    ``T_from_to`` (7,) maps the new frame's camera (``to``) into the stored
    keyframe's camera (``from``); ``sqrt_info`` is the 6×6 measurement
    weight or None. Host numpy arrays."""

    from_client: int
    from_time: float
    to_client: int
    to_time: float
    T_from_to: np.ndarray
    sqrt_info: Optional[np.ndarray] = None
