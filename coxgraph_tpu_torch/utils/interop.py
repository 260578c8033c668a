"""State and configuration carried across between the JAX package and
the port.

States travel as flat dicts of numpy arrays keyed by the dotted field path
of the JAX dataclasses (``collection.layers.sdf``, ``constraints.T_meas``,
…). ``flatten`` walks any dataclass tree — a JAX state or a port state —
and returns its leaves unconverted; the caller turns JAX arrays into numpy
(``np.asarray``). Nothing here imports jax.

``config_from`` copies any object carrying the JAX configs' attribute
names (MapperConfig, VoxelGridSpec, TsdfIntegratorConfig,
PinholeIntrinsics) into the port's frozen dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core import voxel as vx
from ..frontends import synthetic as syn
from ..mapper import submap_mapper as sm
from ..ops import tsdf as tsdf_ops
from ..solver import pose_graph as pg


def flatten(obj, prefix: str = "") -> Dict[str, object]:
    """Dataclass tree → {dotted field path: leaf}."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(val):
            out.update(flatten(val, key + "."))
        else:
            out[key] = val
    return out


def _to_numpy(tree) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in flatten(tree).items()}


def _build(cls, arrays: Dict[str, np.ndarray], device, prefix: str = ""):
    """Instantiate dataclass ``cls`` from the flat dict, recursing into
    fields typed as one of the port's state dataclasses."""
    nested = {"layers": vx.TsdfLayer, "collection": sm.SubmapCollection,
              "constraints": pg.RelPoseConstraints,
              "heights": pg.HeightConstraints}
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if f.name in nested:
            kw[f.name] = _build(nested[f.name], arrays, device, key + ".")
        else:
            kw[f.name] = torch.from_numpy(np.array(arrays[key])).to(device)
    return cls(**kw)


def layer_from_numpy(arrays: Dict[str, np.ndarray], device) -> vx.TsdfLayer:
    """{'sdf', 'weight', 'color', 'block_index', 'block_coords',
    'num_blocks'} numpy arrays → the port's TsdfLayer on ``device``."""
    return _build(vx.TsdfLayer, arrays, device)


def layer_to_numpy(layer: vx.TsdfLayer) -> Dict[str, np.ndarray]:
    return _to_numpy(layer)


def mapper_state_from_numpy(arrays: Dict[str, np.ndarray],
                            device) -> sm.MapperState:
    """Flat dotted-path dict (the JAX MapperState's field names) → the
    port's MapperState on ``device``."""
    return _build(sm.MapperState, arrays, device)


def mapper_state_to_numpy(state: sm.MapperState) -> Dict[str, np.ndarray]:
    return _to_numpy(state)


_CONFIGS = {c.__name__: c for c in (
    sm.MapperConfig, vx.VoxelGridSpec, tsdf_ops.TsdfIntegratorConfig,
    syn.PinholeIntrinsics)}


def config_from(obj):
    """Copy a config object (matched by class name) into the port's frozen
    dataclass of the same name, recursing into nested configs. Raises
    when the source sets a field the port cannot honour yet (a
    MapperConfig's ``local_solver`` or ``point_integrator``)."""
    cls = _CONFIGS.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port config for {type(obj).__name__}")
    for name in ("local_solver", "point_integrator"):
        if getattr(obj, name, None) is not None:
            raise ValueError(f"{type(obj).__name__}.{name} is set, but its "
                             "path is not ported yet")
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
        if type(val).__name__ in _CONFIGS:
            val = config_from(val)
        kw[f.name] = val
    return cls(**kw)
