"""Checkpoint and restore of mapper and server state — port of
``coxgraph_tpu.utils.checkpoint`` (the reference has no online
checkpointing; persistence is end-of-run export only, SURVEY.md §5.4).

The format is the JAX package's: one ``.npz`` per checkpoint holding
every leaf keyed by its path of field names joined with "/" (so a JAX
checkpoint of a MapperState, a layer or a constraint pool loads into the
port's dataclass of the same fields, and the reverse), plus a JSON
sidecar of the server's host state. A restore needs a template of the
same structure: configs are code, state is data.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .tensorops import host, upload


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple]:
    """[(path, leaf)] of a tree of dataclasses, dicts, lists and tuples
    whose leaves are tensors or arrays, in field order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, value in items:
        out.extend(_leaves(value, prefix + (name,)))
    return out


def _rebuild(template: Any, values: Dict[Tuple[str, ...], Any],
             prefix: Tuple[str, ...] = ()) -> Any:
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), values,
                             prefix + (f.name,))
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, prefix + (str(i),))
                              for i, v in enumerate(template))
    return values[prefix]


def save_pytree(path: str, tree: Any) -> int:
    """Write every leaf of ``tree`` to ``path`` (.npz) → bytes written."""
    arrays = {"/".join(p): host(v) for p, v in _leaves(tree)}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return os.path.getsize(path)


def load_pytree(path: str, template: Any) -> Any:
    """Restore a tree saved by ``save_pytree`` into ``template``'s
    structure: each tensor leaf comes back with the template leaf's dtype
    on its device, each array leaf as numpy."""
    data = np.load(path)
    values = {}
    for p, t in _leaves(template):
        key = "/".join(p)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if arr.shape != tuple(np.shape(t)):
            raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                             f"template {tuple(np.shape(t))}")
        if isinstance(t, torch.Tensor):
            values[p] = upload(arr, t.device).to(t.dtype)
        else:
            values[p] = arr
    return _rebuild(template, values)


# ---------------------------------------------------------------------------
# Server checkpointing (submaps + host dicts + the host pools)
# ---------------------------------------------------------------------------


def _pool_arrays(pool) -> Dict[str, np.ndarray]:
    """A server HostPool → the leaves of its solver dataclass."""
    out = {k: v.copy() for k, v in pool.fields.items()}
    out["count"] = np.asarray(pool.count, np.int32)
    return out


def save_server(dirpath: str, server) -> None:
    """Checkpoint a CoxgraphServer (server/fusion_server.py).

    Async-PGO safe: a background solve applies its result under the
    server's ``_state_lock``, so all mutable state is SNAPSHOTTED under
    that lock (references, host copies of the pools and poses, and a
    device copy of nothing: a served layer is the server's own copy and is
    replaced, never updated in place); file IO happens outside it."""
    os.makedirs(dirpath, exist_ok=True)
    with server._state_lock:
        meta: Dict[str, Any] = {
            "n_submaps": len(server.submaps),
            "submaps": [
                {"sid": s.sid, "client_id": s.client_id,
                 "client_submap_id": s.client_submap_id,
                 "start_time": s.start_time, "end_time": s.end_time}
                for s in server.submaps],
            "cli_ser": [[list(k), v] for k, v in server.cli_ser.items()],
            "fused": {str(k): v for k, v in server.fused.items()},
            "last_fusion_time": [[list(k), v]
                                 for k, v in server.last_fusion_time.items()],
            "in_control": server.in_control,
            "T_G_cli_ids": sorted(server.T_G_cli),
            # row m of the constraint pool ↔ kinds[m]
            "constraint_kinds": list(server.constraint_kinds),
        }
        constraints = _pool_arrays(server._cons)
        heights = _pool_arrays(server._heights)
        frames = {f"T_G_cli_{c}": np.asarray(server.T_G_cli[c])
                  for c in server.T_G_cli}
        submap_data = [
            (s.sid, s.layer, np.asarray(s.T_cli_submap),
             np.asarray(s.T_G_submap), np.asarray(s.hist_stamps),
             np.asarray(s.hist_poses))
            for s in server.submaps]
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)
    save_pytree(os.path.join(dirpath, "constraints.npz"), constraints)
    save_pytree(os.path.join(dirpath, "heights.npz"), heights)
    np.savez(os.path.join(dirpath, "frames.npz"), **frames)
    for sid, layer, T_cli, T_G, hs, hp in submap_data:
        save_pytree(os.path.join(dirpath, f"submap_{sid}_layer.npz"), layer)
        np.savez(os.path.join(dirpath, f"submap_{sid}_pose.npz"),
                 T_cli_submap=T_cli, T_G_submap=T_G,
                 hist_stamps=hs, hist_poses=hp)


def _load_pool(path: str, pool) -> None:
    data = np.load(path)
    for k, v in pool.fields.items():
        if data[k].shape != v.shape:
            raise ValueError(f"{path}: {k} shape {data[k].shape} != "
                             f"{v.shape}")
        pool.fields[k] = data[k].astype(v.dtype)
    pool.count = int(data["count"])


def load_server(dirpath: str, server) -> None:
    """Restore into a freshly built CoxgraphServer (same config and
    clients); layers go to the server's device. The clients' own mapper
    states are restored separately."""
    from ..core import voxel as vx
    from ..server.fusion_server import ServerSubmap

    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    with server._state_lock:
        _load_pool(os.path.join(dirpath, "constraints.npz"), server._cons)
        hpath = os.path.join(dirpath, "heights.npz")
        if os.path.exists(hpath):
            _load_pool(hpath, server._heights)
        server.constraint_kinds = list(meta["constraint_kinds"])
        frames = np.load(os.path.join(dirpath, "frames.npz"))
        for c in meta["T_G_cli_ids"]:
            server.T_G_cli[int(c)] = np.asarray(frames[f"T_G_cli_{c}"],
                                                np.float32)
        server.cli_ser = {tuple(k): v for k, v in meta["cli_ser"]}
        server.fused = {int(k): v for k, v in meta["fused"].items()}
        server.last_fusion_time = {tuple(k): v
                                   for k, v in meta["last_fusion_time"]}
        server.in_control = meta["in_control"]
        server.submaps = []
        template = vx.create_tsdf_layer(server.cfg.spec, server.device)
        for sm_meta in meta["submaps"]:
            sid = sm_meta["sid"]
            layer = load_pytree(
                os.path.join(dirpath, f"submap_{sid}_layer.npz"), template)
            pose = np.load(os.path.join(dirpath, f"submap_{sid}_pose.npz"))
            # the version-cached geometry refills at the next query
            server.submaps.append(ServerSubmap(
                sid=sid, client_id=sm_meta["client_id"],
                client_submap_id=sm_meta["client_submap_id"], layer=layer,
                T_cli_submap=np.asarray(pose["T_cli_submap"], np.float32),
                T_G_submap=np.asarray(pose["T_G_submap"], np.float32),
                start_time=sm_meta["start_time"],
                end_time=sm_meta["end_time"],
                hist_stamps=pose["hist_stamps"],
                hist_poses=np.asarray(pose["hist_poses"])))
