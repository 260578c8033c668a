"""Typed YAML config system — port of ``coxgraph_tpu.utils.config``: the
reference's gflags + ROS param server + per-component Config structs
(SURVEY.md §5.6; coxgraph_server.cpp:22-62, server.yaml,
coxgraph_client.yaml) as one YAML file whose sections build the port's
frozen dataclasses. Unknown keys are an error, and ``describe``
pretty-prints the effective config as the reference's operator<< does.

PyYAML is imported inside ``load_yaml`` only: importing this module, or
building configs from a dict, needs no yaml.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

import numpy as np

T = TypeVar("T")


def build_dataclass(cls: Type[T], data: Dict[str, Any]) -> T:
    """Construct (possibly nested) frozen dataclass cls from a dict,
    erroring on unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(
            f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        default = fields[name].default
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[name] = build_dataclass(type(default), value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def describe(cfg: Any, indent: int = 0) -> str:
    """Self-printing config (reference operator<< pattern)."""
    pad = "  " * indent
    lines = [f"{pad}{type(cfg).__name__}:"]
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            lines.append(describe(v, indent + 1))
        else:
            lines.append(f"{pad}  {f.name}: {v}")
    return "\n".join(lines)


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_system_config(path: str):
    """Load a full-system YAML → dict of the port's typed configs.
    Sections: voxel / integrator / intrinsics / mapper / server /
    registration / solver / esdf / features / loop_detector. Any section
    may be omitted (defaults apply); mapper and server embed the shared
    voxel, integrator and intrinsics sections."""
    from ..core import voxel as vx
    from ..frontends import loop_detector as ld
    from ..frontends.synthetic import PinholeIntrinsics
    from ..mapper import submap_mapper as sm
    from ..ops import esdf as esdf_ops
    from ..ops import features as ft
    from ..ops import registration as reg
    from ..ops import tsdf as tsdf_ops
    from ..server import fusion_server as fs
    from ..solver import pose_graph as pg

    raw = load_yaml(path)
    spec = build_dataclass(vx.VoxelGridSpec, raw.get("voxel", {}))
    integ = build_dataclass(tsdf_ops.TsdfIntegratorConfig,
                            raw.get("integrator", {}))
    intr = build_dataclass(PinholeIntrinsics, raw.get("intrinsics", {}))
    regc = build_dataclass(reg.RegistrationConfig, raw.get("registration", {}))
    solver = build_dataclass(pg.SolverConfig, raw.get("solver", {}))
    feat = build_dataclass(ft.FeatureConfig, raw.get("features", {}))

    mapper_kw = dict(raw.get("mapper", {}))
    mapper = sm.MapperConfig(spec=spec, integrator=integ, intrinsics=intr,
                             **mapper_kw)
    server_kw = dict(raw.get("server", {}))
    server = fs.ServerConfig(spec=spec, registration=regc, solver=solver,
                             **server_kw)
    detector_kw = dict(raw.get("loop_detector", {}))
    detector = ld.LoopDetectorConfig(features=feat, **detector_kw)
    esdf = build_dataclass(esdf_ops.EsdfConfig, raw.get("esdf", {}))
    return {
        "spec": spec, "integrator": integ, "intrinsics": intr,
        "mapper": mapper, "server": server, "registration": regc,
        "solver": solver, "features": feat, "loop_detector": detector,
        "esdf": esdf,
    }


def information_matrix_from_params(params: Dict[str, float]) -> np.ndarray:
    """4-DoF (x, y, z, yaw) information matrix from upper-triangle entries
    — parity with setInformationMatrixFromRosParams (utils/ros_params.h:9-32,
    populated from YAML like server.yaml:32-51). Keys: "x_x", "x_y",
    "x_z", "x_yaw", "y_y", "y_z", "y_yaw", "z_z", "z_yaw", "yaw_yaw";
    missing entries default to 0. The upper triangle is mirrored to the
    lower to form a symmetric matrix."""
    names = ("x", "y", "z", "yaw")
    M = np.zeros((4, 4))
    for i in range(4):
        for j in range(i, 4):
            M[i, j] = float(params.get(f"{names[i]}_{names[j]}", 0.0))
            M[j, i] = M[i, j]
    return M


def sqrt_information(M: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """Whitening square root of an information matrix: Cholesky when
    positive-definite, robust eigenvalue-clamped root otherwise (the
    reference's LLT → robust-LDLT fallback,
    relative_pose_constraint.h:28-61)."""
    try:
        return np.linalg.cholesky(M).T
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(M)
        return (V * np.sqrt(np.maximum(w, eps))) @ V.T
