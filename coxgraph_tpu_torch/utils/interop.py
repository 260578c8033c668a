"""State and configuration carried across between the JAX package and
the port.

States travel as flat dicts of numpy arrays keyed by the dotted field path
of the JAX dataclasses (``collection.layers.sdf``, ``constraints.T_meas``,
…). ``flatten`` walks any dataclass tree — a JAX state or a port state —
and returns its leaves unconverted; the caller turns JAX arrays into numpy
(``np.asarray``). Nothing here imports jax.

``config_from`` copies any object carrying the JAX configs' attribute
names (MapperConfig, VoxelGridSpec, TsdfIntegratorConfig,
PinholeIntrinsics, FeatureConfig, LoopDetectorConfig, EsdfConfig,
SolverConfig, RegistrationConfig, PointIntegratorConfig) into the port's
frozen dataclasses.

The solve's inputs and outputs cross too: constraint and height-prior
pools on their own, lists of layers, and ``SolveResult``. So does the
server tier: ``ServerConfig`` and ``MapServerConfig`` (with their nested
configs) through ``config_from``, a served ``SubmapHandle``
(``submap_handle_from``) and an ``InProcessClient`` with its mapper state
(``client_from``).

The parallel tier crosses too: a JAX fleet (every MapperState field with
a leading (R, …) robot axis) to the port's ``Fleet`` of per-robot states
and back (``fleet_from_numpy`` / ``fleet_to_numpy``), a ``ShardedBlocks``
slab partition (``sharded_blocks_from`` / ``sharded_blocks_to_numpy``),
and a stacked layer tree to a list of layers (``layers_from_stacked``).

Keypoints and a loop detector's database cross with their descriptors as
the uint32 words of the JAX package; in the port they are int32 tensors
holding the same bit patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import voxel as vx
from ..frontends import loop_detector as ld
from ..frontends import synthetic as syn
from ..mapper import map_server as msrv
from ..mapper import submap_mapper as sm
from ..ops import esdf as esdf_ops
from ..ops import features as ft
from ..ops import points as points_ops
from ..ops import registration as reg
from ..ops import tsdf as tsdf_ops
from ..parallel import esdf_sharded as es
from ..parallel import fleet as fl
from ..server import client_interface as ci
from ..server import fusion_server as fs
from ..solver import pose_graph as pg
from ..utils.tensorops import host


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
    return {k: host(v) for k, v in flatten(tree).items()}


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


def esdf_layer_from_numpy(arrays: Dict[str, np.ndarray],
                          device) -> esdf_ops.EsdfLayer:
    """{'dist', 'observed', 'block_index', 'block_coords', 'num_blocks'}
    numpy arrays → the port's EsdfLayer on ``device``."""
    return _build(esdf_ops.EsdfLayer, arrays, device)


def esdf_layer_to_numpy(layer: esdf_ops.EsdfLayer) -> Dict[str, np.ndarray]:
    return _to_numpy(layer)


def mapper_state_from_numpy(arrays: Dict[str, np.ndarray],
                            device) -> sm.MapperState:
    """Flat dotted-path dict (the JAX MapperState's field names) → the
    port's MapperState on ``device``."""
    return _build(sm.MapperState, arrays, device)


def mapper_state_to_numpy(state: sm.MapperState) -> Dict[str, np.ndarray]:
    return _to_numpy(state)


def constraints_from_numpy(arrays: Dict[str, np.ndarray],
                           device) -> pg.RelPoseConstraints:
    """{'i', 'j', 'T_meas', 'sqrt_info', 'valid', 'count'} → the port's
    RelPoseConstraints pool on ``device``."""
    return _build(pg.RelPoseConstraints, arrays, device)


def heights_from_numpy(arrays: Dict[str, np.ndarray],
                       device) -> pg.HeightConstraints:
    """{'i', 'height', 'info', 'valid', 'count'} → the port's
    HeightConstraints pool on ``device``."""
    return _build(pg.HeightConstraints, arrays, device)


def pool_to_numpy(pool) -> Dict[str, np.ndarray]:
    """A constraint or height-prior pool (the port's or the JAX
    package's) → {field: numpy}."""
    return _to_numpy(pool)


def mapper_state_from(state, device) -> sm.MapperState:
    """A MapperState (the JAX package's or the port's) → the port's on
    ``device``."""
    return mapper_state_from_numpy(
        {k: host(v) for k, v in flatten(state).items()}, device)


def fleet_from_numpy(arrays: Dict[str, np.ndarray], device,
                     mesh=None) -> fl.Fleet:
    """A stacked fleet as a flat dotted-path dict (every leaf with a
    leading (R, …) robot axis, the JAX fleet's layout) → the port's Fleet
    on ``device``: every robot, or with ``mesh`` (a parallel RobotMesh)
    this rank's robots on ``mesh.device``."""
    R = next(iter(arrays.values())).shape[0]
    rows = range(R) if mesh is None else mesh.share(R)
    dev = device if mesh is None else mesh.device
    return fl.Fleet(states=[mapper_state_from_numpy(
        {k: v[r] for k, v in arrays.items()}, dev) for r in rows],
        first=rows.start, n_robots=R)


def fleet_to_numpy(fleet: fl.Fleet) -> Dict[str, np.ndarray]:
    """The fleet's robots (this rank's) → a flat dict stacked along a
    leading robot axis (the JAX fleet's layout)."""
    per = [mapper_state_to_numpy(st) for st in fleet.states]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def sharded_blocks_from(parts, device) -> es.ShardedBlocks:
    """A slab partition (the JAX package's ShardedBlocks, the port's, or a
    dict of their fields) → the port's on ``device``."""
    arrays = parts if isinstance(parts, dict) else _to_numpy(parts)
    return _build(es.ShardedBlocks, arrays, device)


def sharded_blocks_to_numpy(parts) -> Dict[str, np.ndarray]:
    return _to_numpy(parts)


def layers_from_stacked(stacked, device) -> List[vx.TsdfLayer]:
    """A stacked layer tree (every TsdfLayer field with a leading (S, …)
    axis, e.g. a JAX collection's ``layers``) → a list of the port's
    layers on ``device``."""
    arrays = {f.name: host(getattr(stacked, f.name))
              for f in dataclasses.fields(vx.TsdfLayer)}
    return [layer_from_numpy({k: v[s] for k, v in arrays.items()}, device)
            for s in range(arrays["sdf"].shape[0])]


def submap_handle_from(h, device) -> ci.SubmapHandle:
    """A served SubmapHandle (the JAX package's) → the port's, its layer
    on ``device`` and the rest as host numpy."""
    layer = layer_from_numpy({f.name: host(getattr(h.layer, f.name))
                              for f in dataclasses.fields(h.layer)}, device)
    return ci.SubmapHandle(
        client_id=int(h.client_id), client_submap_id=int(h.client_submap_id),
        layer=layer, T_cli_submap=np.array(host(h.T_cli_submap)),
        start_time=float(h.start_time), end_time=float(h.end_time),
        hist_stamps=np.array(host(h.hist_stamps)),
        hist_poses=np.array(host(h.hist_poses)))


def client_from(client, device) -> ci.InProcessClient:
    """An InProcessClient (the JAX package's) → the port's: its config,
    its mapper state on ``device`` and its send-once bookkeeping."""
    out = ci.InProcessClient(client.client_id, config_from(client.cfg),
                             mapper_state_from(client.state, device))
    out.sent_submaps = set(client.sent_submaps)
    out.bytes_sent = int(client.bytes_sent)
    out.mapping_enabled = bool(client.mapping_enabled)
    out.finished = bool(client.finished)
    return out


def layers_from_numpy(arrays: Sequence[Dict[str, np.ndarray]],
                      device) -> List[vx.TsdfLayer]:
    """A list of per-layer dicts (``layer_from_numpy``'s) → the port's
    layers on ``device``."""
    return [layer_from_numpy(a, device) for a in arrays]


def solve_result_to_numpy(res) -> Dict[str, np.ndarray]:
    """A SolveResult (the JAX package's or the port's) → {'poses',
    'cost', 'initial_cost', 'iterations'} as numpy."""
    return {name: host(getattr(res, name)) for name in pg.SolveResult._fields}


def solve_result_from_numpy(arrays: Dict[str, np.ndarray],
                            device) -> pg.SolveResult:
    return pg.SolveResult(**{
        name: torch.from_numpy(np.array(arrays[name])).to(device)
        for name in pg.SolveResult._fields})


def keypoints_from_numpy(kp, device) -> ft.Keypoints:
    """Keypoints with numpy (or JAX) fields, uint32 descriptors → the
    port's Keypoints on ``device`` (int32 descriptor bit patterns)."""
    fields = {}
    for name in ft.Keypoints._fields:
        a = host(kp[name] if isinstance(kp, dict) else getattr(kp, name))
        if name == "desc":
            a = a.astype(np.uint32).view(np.int32)
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return ft.Keypoints(**fields)


def keypoints_to_numpy(kp: ft.Keypoints) -> Dict[str, np.ndarray]:
    """The port's Keypoints → {field: numpy}, descriptors as uint32."""
    out = {name: host(getattr(kp, name)) for name in ft.Keypoints._fields}
    out["desc"] = out["desc"].view(np.uint32)
    return out


def detector_state_to_numpy(det) -> Dict[str, np.ndarray]:
    """A loop detector's device database and slot metadata → numpy. Works
    on the JAX package's LoopDetector and on the port's (same attribute
    names). Slots: ``slot_client`` (−1 where free) and ``slot_t``; ``free``
    is the free list as stored (slots are popped from its end)."""
    cfg = det.cfg
    cap, K = cfg.max_keyframes, cfg.features.max_keypoints
    pools = {"db_desc": ((cap, K, ft._N_WORDS), np.uint32),
             "db_valid": ((cap, K), bool),
             "db_pcam": ((cap, K, 3), np.float32),
             "db_hdep": ((cap, K), bool)}
    out = {}
    for name, (shape, dtype) in pools.items():
        x = getattr(det, "_" + name)
        x = np.zeros(shape, dtype) if x is None else host(x)
        if x.dtype == np.int32:             # the port's descriptor words
            x = x.view(np.uint32)
        out[name] = x.astype(dtype, copy=False)
    out["slot_client"] = np.array(
        [-1 if kf is None else kf.client_id for kf in det.slots], np.int64)
    out["slot_t"] = np.array(
        [0.0 if kf is None else kf.t for kf in det.slots], np.float64)
    out["free"] = np.array(det._free, np.int64)
    for name in ("n_keyframes", "total_keyframes", "dropped_keyframes"):
        out[name] = np.array(getattr(det, name), np.int64)
    last = sorted(det._last_kf_time.items())
    out["last_kf_client"] = np.array([c for c, _ in last], np.int64)
    out["last_kf_t"] = np.array([t for _, t in last], np.float64)
    return out


def load_detector_state(det: ld.LoopDetector,
                        arrays: Dict[str, np.ndarray]) -> ld.LoopDetector:
    """Load ``detector_state_to_numpy``'s arrays into the port's detector
    IN PLACE (pools copied onto its device, metadata replaced) → det."""
    if arrays["db_desc"].shape != tuple(det._db_desc.shape):
        raise ValueError(f"database shape {arrays['db_desc'].shape} does "
                         f"not fit the detector's {tuple(det._db_desc.shape)}")
    det._db_desc.copy_(torch.from_numpy(
        np.ascontiguousarray(arrays["db_desc"]).view(np.int32)))
    for name in ("db_valid", "db_pcam", "db_hdep"):
        getattr(det, "_" + name).copy_(torch.from_numpy(
            np.ascontiguousarray(arrays[name])))
    det.slots = [None if c < 0 else ld.Keyframe(client_id=int(c), t=float(t))
                 for c, t in zip(arrays["slot_client"], arrays["slot_t"])]
    det._free = [int(s) for s in arrays["free"]]
    for name in ("n_keyframes", "total_keyframes", "dropped_keyframes"):
        setattr(det, name, int(arrays[name]))
    det._last_kf_time = {int(c): float(t) for c, t in zip(
        arrays["last_kf_client"], arrays["last_kf_t"])}
    return det


_CONFIGS = {c.__name__: c for c in (
    sm.MapperConfig, vx.VoxelGridSpec, tsdf_ops.TsdfIntegratorConfig,
    syn.PinholeIntrinsics, ft.FeatureConfig, ld.LoopDetectorConfig,
    esdf_ops.EsdfConfig, pg.SolverConfig, reg.RegistrationConfig,
    fs.ServerConfig, msrv.MapServerConfig,
    points_ops.PointIntegratorConfig)}


def config_from(obj):
    """Copy a config object (matched by class name) into the port's frozen
    dataclass of the same name, recursing into nested configs. Only the
    port's fields are read: a JAX config's TPU-only fields (those of
    ``TsdfIntegratorConfig`` for the Pallas path and working set) are
    dropped by design."""
    cls = _CONFIGS.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port config for {type(obj).__name__}")
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
        if type(val).__name__ in _CONFIGS:
            val = config_from(val)
        kw[f.name] = val
    return cls(**kw)
