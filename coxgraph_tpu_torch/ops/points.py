"""Point-cloud TSDF integration (the "merged" integrator) — port of
``coxgraph_tpu.ops.points``: the voxblox point-cloud integrator family
(merged / simple, selected per node by the ``method`` param;
integratePointCloud at tsdf_recover.h:75). It takes ARBITRARY unordered
clouds — lidar scans, points decoded from a mesh, clouds with no pinhole
model — where the projective integrator (ops/tsdf.py) takes organized
RGB-D frames.

The same three steps as the JAX package, in plain torch (the JAX package
computes them outside Pallas):

  1. **Bundling**: points are grouped by containing voxel (a sort of
     (block cell, local voxel) keys and segment sums), one ray per
     occupied voxel carrying the weighted-mean position and colour and
     the SUMMED weight of its points. ``merge_points=False`` is the
     "simple" per-point variant.
  2. **Band sampling**: each bundle emits ``band_samples`` points along
     its ray across [-τ, τ], plus optional ``carve_samples`` free-space
     samples toward the sensor. Each updated voxel gets the voxblox SDF:
     the distance along the ray from its own centre's projection.
  3. **Update**: samples land in a compact (K, v³) touched-block buffer
     through one scatter-add, then merge into the pool with the running
     weighted average of the projective path, one row write per block.

The segment sums and the scatter-add are ``index_add_``: on the CPU it
adds in index order, as XLA's CPU scatter does, so the bundles match the
JAX package's bit for bit; on CUDA its atomics add in an unspecified
order, so the card's bundles and sums differ from the CPU's in the last
bits, and a band sample on a voxel boundary may land in the neighbour
(``tests/test_torch_cuda.py`` states the tolerance).

Every call updates the layers IN PLACE. ``integrate_points`` is the
single-layer form (the JAX package's ``integrate_points_impl`` and its
jitted wrapper are one function here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..utils.tensorops import f32_reciprocal, linspace, put_rows

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointIntegratorConfig:
    """Static parameters of the point-cloud integrator (the JAX package's
    fields and defaults; reference operating point: max range 10 m,
    truncation 0.15 m).

    ``band_samples``: ray samples across [-τ, τ]; 7 is one voxel step at
    τ = 0.15, voxel 0.05. An oblique ray may put 0 or 2 samples in one
    voxel, so the per-voxel weight varies with the ray angle (≤ 2× per
    ray per voxel). ``carve_samples``: free-space samples sensor →
    (surface − τ); 0 = carving off (voxel_carving_enabled=false)."""

    max_range: float = 10.0
    min_range: float = 0.1
    max_weight: float = 1.0e4
    band_samples: int = 7
    carve_samples: int = 0
    max_touched_blocks: int = 2048
    use_distance_weight: bool = True   # 1/d² observation weighting
    use_dropoff: bool = True           # linear drop-off behind surface
    merge_points: bool = True          # False = "simple" per-point rays


def points_cfg_from(integrator) -> PointIntegratorConfig:
    """The point integrator at a projective integrator's settings (range,
    weight cap, lanes, weighting): the mapper's default when its config
    names none, and the "merged" recovery's."""
    return PointIntegratorConfig(
        max_range=integrator.max_range, min_range=integrator.min_range,
        max_weight=integrator.max_weight,
        max_touched_blocks=integrator.max_touched_blocks,
        use_distance_weight=integrator.use_distance_weight,
        use_dropoff=integrator.use_dropoff)


def backproject(intr: PinholeIntrinsics, depth: Tensor) -> Tensor:
    """Depth (H,W) → camera-frame points (H,W,3) at the pixel centres (a
    depth image as a cloud; the JAX package's ``tsdf._backproject``)."""
    u = torch.arange(intr.width, dtype=torch.float32, device=depth.device)
    v = torch.arange(intr.height, dtype=torch.float32, device=depth.device)
    x = ((u[None, :] - intr.cx) * f32_reciprocal(intr.fx)) * depth
    y = ((v[:, None] - intr.cy) * f32_reciprocal(intr.fy)) * depth
    return torch.stack([x, y, depth], dim=-1)


def _seg_sum(x: Tensor, seg: Tensor, n: int) -> Tensor:
    return torch.zeros((n,), dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def _bundle_points(spec: vx.VoxelGridSpec, px, py, pz, cr, cg, cb, w,
                   valid):
    """Merge points by containing voxel (the "merged" integrator's
    bundling as a sort and segment sums). All inputs (N,) SoA → SoA
    bundles (N,-shaped, mask-padded): (px, py, pz, cr, cg, cb, w_sum,
    valid), positions and colours weighted means, the weight the SUM."""
    n = px.shape[0]
    vox = vx.point_to_voxel(spec, torch.stack([px, py, pz], dim=-1))
    b, l = vx.voxel_to_block(spec, vox)
    cell = vx.block_grid_slot(spec, b)
    vps = spec.voxels_per_side
    lin = (l[..., 0] * vps + l[..., 1]) * vps + l[..., 2]
    ok = valid & vx.block_in_grid(spec, b)
    g3 = spec.grid_dim ** 3
    cell = torch.where(ok, cell, g3)          # invalid sorts to the end
    # the lexicographic (cell, lin) order as one int64 key; stable, as
    # jnp.lexsort is
    key = cell.to(torch.int64) * vps ** 3 + lin.to(torch.int64)
    perm = torch.sort(key, stable=True).indices
    key_s = key[perm]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=px.device),
                       key_s[1:] != key_s[:-1]])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1      # sorted ids

    ok_s = ok[perm]
    wv = torch.where(ok, w, 0.0)
    sw = _seg_sum(wv[perm], seg, n)
    denom = torch.clamp(sw, min=1e-12)
    out = [_seg_sum((wv * q)[perm], seg, n) / denom
           for q in (px, py, pz, cr, cg, cb)]
    b_valid = _seg_sum(ok_s.to(torch.float32), seg, n) > 0
    return (*out, sw, b_valid)


def integrate_points_stacked_impl(
        spec: vx.VoxelGridSpec, cfg: PointIntegratorConfig,
        layers: vx.TsdfLayer, k: Tensor, points: Tensor,
        colors: Optional[Tensor], valid: Tensor, T_sm_sensor: Tensor,
        return_stats: bool = False):
    """Integrate one point cloud into submap ``k`` (0-d int32 device
    tensor) of a STACKED collection (a leading (S,) axis on every layer
    field), IN PLACE, through a flat (S·max_blocks) view of the pools.

    points: (N,3) sensor frame; colors: (N,3) in [0,1] or None; valid:
    (N,) bool; T_sm_sensor: (7,) sensor pose in the submap frame.
    ``return_stats=True`` also returns the (max_blocks,) bool bitmap of
    updated slots (the MapperState.mesh_dirty feed). No host read."""
    device = points.device
    S = layers.sdf.shape[0]
    mb = spec.max_blocks
    g3 = spec.grid_dim ** 3
    vps = spec.voxels_per_side
    v3 = vps ** 3
    tau = spec.truncation
    f32 = torch.float32
    kk = k.reshape(1).long()
    base = k.to(torch.int64) * mb

    # ---- sensor frame → submap frame, SoA components -----------------
    R = geo.quat_to_matrix(T_sm_sensor[:4])
    t = T_sm_sensor[4:7]
    sx, sy, sz = points[:, 0], points[:, 1], points[:, 2]
    px = R[0, 0] * sx + R[0, 1] * sy + R[0, 2] * sz + t[0]
    py = R[1, 0] * sx + R[1, 1] * sy + R[1, 2] * sz + t[1]
    pz = R[2, 0] * sx + R[2, 1] * sy + R[2, 2] * sz + t[2]

    def ray_length(x, y, z):
        return torch.sqrt(torch.clamp(
            (x - t[0]) ** 2 + (y - t[1]) ** 2 + (z - t[2]) ** 2, min=1e-12))

    dist = ray_length(px, py, pz)
    valid = valid & (dist > cfg.min_range) & (dist < cfg.max_range)
    if colors is None:
        cr = cg = cb = torch.zeros_like(px)
    else:
        cr, cg, cb = colors[:, 0], colors[:, 1], colors[:, 2]
    w0 = torch.ones_like(px)
    if cfg.use_distance_weight:
        w0 = w0 / torch.clamp(dist * dist, min=1.0)

    # ---- bundling (merged) -------------------------------------------
    if cfg.merge_points:
        px, py, pz, cr, cg, cb, wb, valid = _bundle_points(
            spec, px, py, pz, cr, cg, cb, w0, valid)
        dist = ray_length(px, py, pz)
    else:
        wb = torch.where(valid, w0, 0.0)
    dirx = (px - t[0]) / dist
    diry = (py - t[1]) / dist
    dirz = (pz - t[2]) / dist

    # ---- static sample offsets along each ray ------------------------
    Sb, Sc = cfg.band_samples, cfg.carve_samples
    d_all = dist[None, :] + linspace(-tau, tau, Sb, device)[:, None]
    carve_row = torch.zeros((Sb, 1), dtype=torch.bool, device=device)
    if Sc:
        # carve: min_range → dist − τ, per-ray stride (coarse free space)
        frac = linspace(0.0, 1.0, Sc + 1, device)[:-1][:, None]
        d_carve = cfg.min_range + frac * torch.clamp(
            dist[None, :] - tau - cfg.min_range, min=0.0)
        d_all = torch.cat([d_all, d_carve])                # (Ss, N)
        carve_row = torch.arange(Sb + Sc, device=device)[:, None] >= Sb
    qx = t[0] + dirx[None] * d_all
    qy = t[1] + diry[None] * d_all
    qz = t[2] + dirz[None] * d_all
    s_valid = valid[None] & (d_all > cfg.min_range)

    # ---- allocation (submap k's small arrays only) -------------------
    inv = 1.0 / spec.voxel_size
    gx = torch.floor(qx * inv).to(torch.int32)
    gy = torch.floor(qy * inv).to(torch.int32)
    gz = torch.floor(qz * inv).to(torch.int32)
    bxc = torch.div(gx, vps, rounding_mode="floor")
    byc = torch.div(gy, vps, rounding_mode="floor")
    bzc = torch.div(gz, vps, rounding_mode="floor")
    h = spec.half_grid
    gd = spec.grid_dim
    in_grid = ((bxc >= -h) & (bxc < h) & (byc >= -h) & (byc < h)
               & (bzc >= -h) & (bzc < h))
    cell = ((torch.clamp(bxc + h, 0, gd - 1) * gd
             + torch.clamp(byc + h, 0, gd - 1)) * gd
            + torch.clamp(bzc + h, 0, gd - 1))
    s_valid = s_valid & in_grid

    K = min(cfg.max_touched_blocks, mb)
    bi_all = layers.block_index.view(S, g3)
    bi_k, bc_k, nb_k, slots, slot_mask = vx.allocate_and_slots(
        spec, bi_all.index_select(0, kk)[0],
        layers.block_coords.index_select(0, kk)[0],
        layers.num_blocks.index_select(0, kk)[0],
        cell.reshape(-1), s_valid.reshape(-1), K)
    bi_all.index_copy_(0, kk, bi_k[None])
    layers.block_coords.index_copy_(0, kk, bc_k[None])
    layers.num_blocks.index_copy_(0, kk, nb_k[None])

    # ---- per-sample voxel update values ------------------------------
    # the voxblox SDF: project the VOXEL CENTRE onto the ray
    vs = spec.voxel_size
    d_vc = (((gx.to(f32) + 0.5) * vs - t[0]) * dirx[None]
            + ((gy.to(f32) + 0.5) * vs - t[1]) * diry[None]
            + ((gz.to(f32) + 0.5) * vs - t[2]) * dirz[None])
    sdf = dist[None] - d_vc
    w_obs = wb[None].expand_as(sdf)
    if cfg.use_dropoff:
        # the projective path's ramp: 1 → 0 from −τ/2 to −τ
        dropoff = torch.clamp((sdf + tau) * f32_reciprocal(0.5 * tau),
                              0.0, 1.0)
        w_obs = w_obs * torch.where(carve_row, 1.0, dropoff)
    w_obs = torch.where(s_valid & (sdf > -tau), w_obs, 0.0)
    sdf_obs = torch.clamp(sdf, -tau, tau)
    near = (torch.abs(sdf) < tau) & ~carve_row

    # ---- compact scatter-add into the K touched block rows -----------
    pool_slot = bi_k[cell.reshape(-1).long()]              # post-alloc
    compact = torch.full((mb + 1,), K, dtype=torch.int32, device=device)
    compact[torch.where(slot_mask, slots, mb).long()] = torch.arange(
        K, dtype=torch.int32, device=device)
    ci = compact[torch.clamp(pool_slot, 0, mb).long()]     # K = drop
    lin = (((gx - bxc * vps) * vps + (gy - byc * vps)) * vps
           + (gz - bzc * vps)).reshape(-1)
    live = (w_obs.reshape(-1) > 0) & (pool_slot >= 0) & (ci < K)
    addr = torch.where(live, ci * v3 + lin, K * v3).long()
    wf = torch.where(live, w_obs.reshape(-1), 0.0)

    def accumulate(x):
        return torch.zeros((K * v3 + 1,), dtype=f32, device=device
                           ).index_add_(0, addr, x)[:K * v3].reshape(K, v3)

    aw = accumulate(wf)
    aws = accumulate(wf * sdf_obs.reshape(-1))

    # ---- merge into the pool (flat stacked view, one write per row) --
    sdf_pool = layers.sdf.view(S * mb, v3)
    w_pool = layers.weight.view(S * mb, v3)
    rows = torch.clamp(base + slots, max=S * mb - 1)
    old_sdf = sdf_pool[rows]                               # (K, v³)
    old_w = w_pool[rows]
    new_w = torch.clamp(old_w + aw, max=cfg.max_weight)
    denom = torch.clamp(new_w, min=1e-9)
    new_sdf = torch.where(new_w > 0, (old_w * old_sdf + aws) / denom,
                          old_sdf)
    if colors is not None:
        wn = torch.where(live & near.reshape(-1), wf, 0.0)
        c_pool = layers.color.view(S * mb, 3 * v3)
        old_c = c_pool[rows]                               # planar
        new_c = torch.cat(
            [torch.where(new_w > 0,
                         (old_w * old_c[:, ch * v3:(ch + 1) * v3]
                          + accumulate(wn * c[None].expand_as(near)
                                       .reshape(-1))) / denom,
                         old_c[:, ch * v3:(ch + 1) * v3])
             for ch, c in enumerate((cr, cg, cb))], dim=1)
        put_rows(c_pool, rows, slot_mask, new_c)
    put_rows(sdf_pool, rows, slot_mask, new_sdf)
    put_rows(w_pool, rows, slot_mask, new_w)
    if return_stats:
        touched = torch.zeros((mb + 1,), dtype=torch.bool, device=device)
        touched.index_fill_(0, torch.where(slot_mask, slots, mb).long(),
                            True)
        return layers, touched[:mb]
    return layers


def integrate_points(spec: vx.VoxelGridSpec, cfg: PointIntegratorConfig,
                     layer: vx.TsdfLayer, points: Tensor,
                     colors: Optional[Tensor], valid: Tensor,
                     T_sm_sensor: Tensor) -> vx.TsdfLayer:
    """Integrate one point cloud into a single layer, IN PLACE (an S = 1
    view of the stacked path); returns ``layer``."""
    stacked = vx.TsdfLayer(**{f.name: getattr(layer, f.name)[None]
                              for f in dataclasses.fields(layer)})
    k = torch.zeros((), dtype=torch.int32, device=points.device)
    integrate_points_stacked_impl(spec, cfg, stacked, k, points, colors,
                                  valid, T_sm_sensor)
    return layer
