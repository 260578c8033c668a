"""Block-sharded ESDF propagation over a process group — port of
``coxgraph_tpu.parallel.esdf_sharded`` (the spatial scaling axis of
SURVEY.md §5.7): the map's voxel blocks split into x-slabs of the block
grid, the masked-Jacobi sweeps (ops/esdf.py) run on every slab, and only
the slab-boundary blocks move between slabs after each sweep.

Each slab owns the blocks whose bx falls in it, in a fixed-capacity
sub-pool, PLUS two halo regions that mirror the neighbouring slabs' edge
blocks. Its block-index grid maps own blocks to own slots [0, Bd) and the
neighbours' edge blocks to the left halo [Bd, Bd+E) and the right halo
[Bd+E, Bd+2E), so a sweep reads across blocks exactly as the
single-device one does; a halo refresh after every sweep keeps global
Jacobi semantics (a sweep moves information ≤ 1 voxel ≤ 1 block). A
min-plus sweep does not depend on summation order, so the result equals
``ops.esdf.esdf_from_tsdf`` bit for bit.

D slabs split over the ranks ``RobotMesh.share(D)``; a rank sweeps its
slabs one after the other, and one gather of every slab's edge blocks
refreshes all halos after each sweep.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

from ..core import voxel as vx
from ..ops import esdf as esdf_ops
from ..utils.tensorops import host, scatter_drop
from .collectives import RobotMesh, gather_rows

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardedEsdfConfig:
    per_device_blocks: int = 1024   # own-block capacity per slab
    halo_blocks: int = 256          # edge-block capacity per side
    esdf: esdf_ops.EsdfConfig = esdf_ops.EsdfConfig()


@dataclasses.dataclass
class ShardedBlocks:
    """The slab partition (every field has a leading (D,) slab axis)."""

    coords: Tensor        # (D, Bd, 3) own block coords
    init: Tensor          # (D, Bd, v,v,v) ESDF init (band ∪ ±md)
    band: Tensor          # (D, Bd, v,v,v) frozen surface band
    observed: Tensor      # (D, Bd, v,v,v)
    live: Tensor          # (D, Bd) own-block validity
    send_left: Tensor     # (D, E) own slot ids whose bx == slab min
    send_right: Tensor    # (D, E) own slot ids whose bx == slab max
    send_left_n: Tensor   # (D,)
    send_right_n: Tensor  # (D,)


def slab_bounds(spec: vx.VoxelGridSpec, n_dev: int) -> np.ndarray:
    """Slab boundaries over bx ∈ [-G/2, G/2): n_dev equal slabs."""
    edges = np.linspace(-spec.half_grid, spec.half_grid, n_dev + 1)
    return np.floor(edges).astype(np.int64)


def _live_coords(tsdf: vx.TsdfLayer) -> np.ndarray:
    return host(tsdf.block_coords[:int(tsdf.num_blocks)])


def fitted_config(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer, n_dev: int,
                  esdf: esdf_ops.EsdfConfig = esdf_ops.EsdfConfig()
                  ) -> ShardedEsdfConfig:
    """The least capacities that hold ``tsdf``'s partition into n_dev
    slabs: the fullest slab and the fullest slab-face column."""
    coords = _live_coords(tsdf)
    edges = slab_bounds(spec, n_dev)
    bd, e = 1, 1
    for lo, hi in zip(edges[:-1], edges[1:]):
        bx = coords[:, 0]
        bd = max(bd, int(((bx >= lo) & (bx < hi)).sum()))
        e = max(e, int((bx == lo).sum()), int((bx == hi - 1).sum()))
    return ShardedEsdfConfig(per_device_blocks=bd, halo_blocks=e, esdf=esdf)


def partition_blocks(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                     n_dev: int, cfg: ShardedEsdfConfig) -> ShardedBlocks:
    """Host-side slab partition of a TSDF layer's live blocks, on the
    layer's device (runs once per batch rebuild — not the hot loop)."""
    Bd, E = cfg.per_device_blocks, cfg.halo_blocks
    v = spec.voxels_per_side
    md = np.float32(cfg.esdf.max_distance)
    n = int(tsdf.num_blocks)
    coords = host(tsdf.block_coords)[:n]
    sdf = host(tsdf.sdf)[:n].reshape(n, v, v, v)
    w = host(tsdf.weight)[:n].reshape(n, v, v, v)
    observed = w > 1e-6
    band = observed & (np.abs(sdf) < spec.truncation)
    init = np.where(band, sdf, np.where(sdf >= 0, md, -md))
    init = np.where(observed, init, md).astype(np.float32)

    edges = slab_bounds(spec, n_dev)
    out = {f.name: [] for f in dataclasses.fields(ShardedBlocks)}
    for d in range(n_dev):
        lo, hi = edges[d], edges[d + 1]
        sel = np.where((coords[:, 0] >= lo) & (coords[:, 0] < hi))[0]
        if len(sel) > Bd:
            raise ValueError(f"slab {d} has {len(sel)} blocks > capacity "
                             f"{Bd} (see fitted_config)")
        k = len(sel)
        c = np.zeros((Bd, 3), np.int32)
        c[:k] = coords[sel]
        # unused slots get far-away coords so they never hit the grid
        c[k:] = spec.half_grid + 7
        ini = np.full((Bd, v, v, v), md, np.float32)
        ini[:k] = init[sel]
        bnd = np.zeros((Bd, v, v, v), bool)
        bnd[:k] = band[sel]
        obs = np.zeros((Bd, v, v, v), bool)
        obs[:k] = observed[sel]
        live = np.zeros((Bd,), bool)
        live[:k] = True
        # edge blocks: the column adjacent to each slab face (a sweep
        # reads ≤ 1 voxel across, so one block column suffices)
        sl = np.where(c[:k, 0] == lo)[0]
        sr = np.where(c[:k, 0] == hi - 1)[0]
        if len(sl) > E or len(sr) > E:
            raise ValueError(f"slab {d}'s face columns hold {len(sl)} and "
                             f"{len(sr)} blocks > halo capacity {E}")
        for name, val in (("coords", c), ("init", ini), ("band", bnd),
                          ("observed", obs), ("live", live),
                          ("send_left", np.pad(sl, (0, E - len(sl)))),
                          ("send_right", np.pad(sr, (0, E - len(sr)))),
                          ("send_left_n", len(sl)),
                          ("send_right_n", len(sr))):
            out[name].append(val)
    dev = tsdf.sdf.device
    ints = ("send_left", "send_right", "send_left_n", "send_right_n")
    return ShardedBlocks(**{
        name: torch.from_numpy(np.stack(vals).astype(np.int32)
                               if name in ints else np.stack(vals)).to(dev)
        for name, vals in out.items()})


def _flat_index(spec: vx.VoxelGridSpec, parts, Bd: int, E: int):
    """(g3,) int32 grid cell → row of the extended pool (own, left halo,
    right halo), −1 where none."""
    g3 = spec.grid_dim ** 3
    fi = torch.full((g3,), -1, dtype=torch.int32, device=parts[0][0].device)
    for base, (cs, ms) in zip((0, Bd, Bd + E), parts):
        ok = ms & vx.block_in_grid(spec, cs)
        fi = scatter_drop(fi, torch.where(ok, vx.block_grid_slot(spec, cs),
                                          g3),
                          base + torch.arange(cs.shape[0], dtype=torch.int32,
                                              device=cs.device))
    return fi


def esdf_sharded(spec: vx.VoxelGridSpec, mesh: RobotMesh,
                 parts: ShardedBlocks, cfg: ShardedEsdfConfig) -> Tensor:
    """Distributed ESDF sweeps → this rank's slabs' distance (L, Bd,
    v,v,v), L = len(mesh.share(D)).

    Every slab sweeps its own blocks; after each sweep one gather carries
    every slab's edge-block distances into its neighbours' halo slots.
    Equal to the single-device esdf_from_tsdf (same Jacobi schedule)."""
    Bd, E = cfg.per_device_blocks, cfg.halo_blocks
    v = spec.voxels_per_side
    md = cfg.esdf.max_distance
    D = parts.coords.shape[0]
    mine = mesh.share(D)
    dev = parts.coords.device
    offs = esdf_ops._neighbor_offsets(cfg.esdf.full_connectivity)
    # ‖Δ‖·voxel_size in f32, as ops.esdf computes it
    step = (np.sqrt((offs.astype(np.float32) ** 2).sum(axis=-1,
                                                       dtype=np.float32))
            * np.float32(spec.voxel_size)).astype(np.float32)
    n_iters = math.ceil(md / spec.voxel_size) + cfg.esdf.extra_iters
    offs_py = [tuple(int(c) for c in o) for o in offs.tolist()]
    ar = torch.arange(E, device=dev)

    def edge_rows(x, d):
        """Slab d's left- and right-face rows of its own (Bd, …) ``x``."""
        sl = torch.clamp(parts.send_left[d], max=Bd - 1).long()
        sr = torch.clamp(parts.send_right[d], max=Bd - 1).long()
        return torch.stack([x[sl], x[sr]])                  # (2, E, …)

    def stacked(rows, shape):
        """(L, 2, E, …) rows of this rank's slabs (a rank may hold none)."""
        return (torch.stack(rows) if rows else
                torch.zeros((0, 2, E) + shape, dtype=torch.float32,
                            device=dev))

    # setup: the neighbours' edge coords and masks, exchanged once
    geo_rows = stacked([edge_rows(torch.cat([
        parts.coords[d], torch.ones_like(parts.coords[d][:, :1])], 1), d)
        * torch.stack([ar < parts.send_left_n[d],
                       ar < parts.send_right_n[d]])[..., None]
        for d in mine], (4,)).to(torch.int32)              # (L, 2, E, 4)
    geo_all = gather_rows(mesh, geo_rows, D, mine.start)
    slabs = []
    for d in mine:
        # wrap-around neighbours at the domain ends are masked off
        hl = geo_all[d - 1, 1] if d > 0 else torch.zeros_like(geo_all[d, 1])
        hr = (geo_all[d + 1, 0] if d < D - 1
              else torch.zeros_like(geo_all[d, 0]))
        fi = _flat_index(spec, ((parts.coords[d], parts.live[d]),
                                (hl[:, :3], hl[:, 3] > 0),
                                (hr[:, :3], hr[:, 3] > 0)), Bd, E)
        coords = parts.coords[d]
        diag = {}
        if cfg.esdf.full_connectivity:
            r = torch.arange(v, dtype=torch.int32, device=dev)
            local = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                                dim=-1)
            gvox = coords[:, None, None, None, :] * v + local
            for o in offs_py:
                if sum(abs(c) for c in o) == 1:
                    continue
                b, lv = vx.voxel_to_block(spec, vx.shift(gvox, o))
                slot = vx.block_grid_slot(spec, b).long()
                idx = torch.where(vx.block_in_grid(spec, b), fi[slot], -1)
                lin = ((torch.clamp(idx, min=0).long() * v + lv[..., 0]) * v
                       + lv[..., 1]) * v + lv[..., 2]
                diag[o] = (idx >= 0, lin)
        live4 = parts.live[d][:, None, None, None]
        init_m = torch.where(live4, parts.init[d], md)
        slabs.append({
            "d": d, "face": esdf_ops.face_neighbor_indices(spec, coords, fi),
            "diag": diag, "live4": live4, "init": init_m,
            "band": parts.band[d],
            "hl_m": (hl[:, 3] > 0)[:, None, None, None],
            "hr_m": (hr[:, 3] > 0)[:, None, None, None],
            "ext": torch.cat([init_m, init_m.new_full((2 * E, v, v, v), md)]),
        })

    def refresh():
        send = stacked([edge_rows(s["ext"][:Bd], s["d"]) for s in slabs],
                       (v, v, v))
        got = gather_rows(mesh, send, D, mine.start)     # (D, 2, E, v,v,v)
        for s in slabs:
            d = s["d"]
            if d > 0:
                s["ext"][Bd:Bd + E] = torch.where(s["hl_m"], got[d - 1, 1],
                                                  md)
            if d < D - 1:
                s["ext"][Bd + E:] = torch.where(s["hr_m"], got[d + 1, 0], md)

    refresh()
    for _ in range(n_iters):
        for s in slabs:
            ext = s["ext"]
            dd = ext[:Bd]
            pos_best = torch.full_like(dd, md)
            neg_best = torch.full_like(dd, -md)
            for a, o in enumerate(offs_py):
                if o in s["diag"]:
                    ok, lin = s["diag"][o]
                    dn = torch.where(ok, ext.reshape(-1)[lin], md)
                else:
                    dn = esdf_ops.axis_neighbor_field(ext, dd, s["face"], o,
                                                      v, md)
                st = float(step[a])
                pos_best = torch.minimum(pos_best,
                                         torch.clamp(dn, min=0.0) + st)
                neg_best = torch.maximum(neg_best,
                                         torch.clamp(dn, max=0.0) - st)
            d_new = torch.where(dd >= 0, torch.minimum(dd, pos_best),
                                torch.maximum(dd, neg_best))
            d_new = torch.where(s["band"], s["init"], d_new)
            ext[:Bd] = torch.where(s["live4"], d_new, md)
        refresh()
    return torch.stack([torch.clamp(s["ext"][:Bd], -md, md) for s in slabs]
                       ) if slabs else parts.init[:0]


def gather_to_layer(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                    parts: ShardedBlocks, dist: Tensor,
                    mesh: RobotMesh) -> esdf_ops.EsdfLayer:
    """Gather every rank's slabs (``dist``: this rank's, esdf_sharded's
    result) back into an EsdfLayer aligned with the source TSDF layer's
    pool, on every rank; blocks without a result read max|dist|."""
    D, Bd = parts.live.shape
    dist = gather_rows(mesh, dist, D)
    mb = tsdf.max_blocks
    idx = vx.lookup_block(spec, tsdf, parts.coords.reshape(-1, 3))
    ok = parts.live.reshape(-1) & (idx >= 0)
    fill = dist.abs().max().expand(mb, dist[0, 0].numel())
    out = scatter_drop(fill, torch.where(ok, idx, mb),
                       dist.reshape(D * Bd, -1))
    return esdf_ops.EsdfLayer(dist=out, observed=tsdf.weight > 1e-6,
                              block_index=tsdf.block_index,
                              block_coords=tsdf.block_coords,
                              num_blocks=tsdf.num_blocks)


def ici_bytes_per_update(spec: vx.VoxelGridSpec,
                         cfg: ShardedEsdfConfig) -> dict:
    """Static ICI traffic accounting for one sharded ESDF batch update —
    the exchange-layer byte counters promised by SURVEY.md §5.1/§5.8
    (node_evaluator bandwidth parity for the intra-slice fabric). All
    collective payloads here have static shapes, so the counts are exact:
    each halo refresh moves the edge-block distances (halo_blocks · v³
    f32) once per direction per device, once at setup plus once per
    Jacobi sweep; setup additionally ships edge coords + masks."""
    v3 = spec.voxels_per_side ** 3
    n_sweeps = math.ceil(cfg.esdf.max_distance / spec.voxel_size) \
        + cfg.esdf.extra_iters
    per_refresh = 2 * cfg.halo_blocks * v3 * 4          # both directions
    setup = 2 * cfg.halo_blocks * (3 * 4 + 1)           # coords + mask
    return {
        "n_sweeps": n_sweeps,
        "per_sweep_bytes": per_refresh,
        "per_device_bytes": setup + (n_sweeps + 1) * per_refresh,
    }
