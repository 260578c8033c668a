"""Plain projective TSDF integration: the semantics that the port's mapper
(allocation pass + K1) has to reproduce, written out again in plain
PyTorch, frame by frame, with no kernel and no shared code.

Per frame, in the submap frame:
  1. allocation: every 4th pixel's depth, moved by −τ, 0 and +τ along its
     ray, names a block (16³ voxels); the K smallest new block cells in
     grid order take the next pool rows;
  2. update: each voxel centre of each named block is projected into the
     image, rounded to a pixel (half to even), and its depth d gives
       sdf = d − z, observed where d ∈ (min, max) and sdf > −τ,
       w_obs = 1/max(d², 1) · clip((sdf + τ)/(τ/2), 0, 1),
       new_w = min(w + w_obs, w_max),
       sdf ← (w·sdf + w_obs·clip(sdf, ±τ)) / new_w,
       rgb ← (w·rgb + w_obs·[|sdf| < τ]·pixel) / new_w  (where new_w > 0).

``dtype`` is the arithmetic's precision: float32 as the deployment states,
or a lower one for the control that ``correct`` must reject.
"""

from __future__ import annotations

import dataclasses

import torch

from . import geometry as geo

Tensor = torch.Tensor
TIE_PX = 1e-3
TIE_M = 1e-5


def _recip(x: float) -> float:
    """1/x rounded to float32: a division by a constant is a product."""
    return float(torch.tensor(1.0 / x, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class Grid:
    voxel_size: float
    voxels_per_side: int
    grid_dim: int
    max_blocks: int
    truncation: float
    max_range: float
    min_range: float
    max_weight: float
    max_touched_blocks: int
    alloc_band_samples: int
    alloc_stride: int
    use_dropoff: bool
    use_distance_weight: bool

    @staticmethod
    def of(cfg: dict) -> "Grid":
        return Grid(**{f.name: cfg["tsdf"][f.name]
                       for f in dataclasses.fields(Grid)})


class Layer:
    """One submap: a dense grid of pool rows (−1 where unallocated) and
    the rows' block coordinates and voxels, rows in allocation order."""

    def __init__(self, g: Grid, device, dtype=torch.float32, rows=None):
        v3 = g.voxels_per_side ** 3
        cap = g.max_blocks if rows is None else rows
        self.g, self.dtype = g, dtype
        self.grid = torch.full((g.grid_dim ** 3,), -1, dtype=torch.int64,
                               device=device)
        self.coords = torch.zeros((cap, 3), dtype=torch.int64, device=device)
        self.sdf = torch.full((cap, v3), g.truncation, dtype=dtype,
                              device=device)
        self.weight = torch.zeros((cap, v3), dtype=dtype, device=device)
        self.color = torch.zeros((cap, 3, v3), dtype=dtype, device=device)
        # voxels an update reached at a rounding tie (a pixel coordinate
        # within TIE_PX of a half pixel, or sdf within TIE_M of −τ or τ):
        # there float32 rounding alone decides which value the update
        # takes, so these are where two sound float32 programs can differ
        self.tie = torch.zeros((cap, v3), dtype=torch.bool, device=device)
        self.n = 0

    def rows(self):
        """(coords, sdf, weight, colour) of the allocated rows, float32."""
        n, f = self.n, torch.float32
        return (self.coords[:n], self.sdf[:n].to(f), self.weight[:n].to(f),
                self.color[:n].reshape(n, -1).to(f))


def _cells(g: Grid, depth: Tensor, T_sm_cam: Tensor, cam, dt) -> Tensor:
    """The grid cells the frame's truncation band touches, ascending."""
    st = g.alloc_stride
    d = depth[::st, ::st].to(dt)
    ks = torch.linspace(-g.truncation, g.truncation, g.alloc_band_samples,
                        dtype=torch.float64).to(dt).to(depth.device)
    ds = d[None] + ks[:, None, None]
    u = (torch.arange(0, cam.width, st, device=depth.device).to(dt)
         - cam.cx) * _recip(cam.fx)
    v = (torch.arange(0, cam.height, st, device=depth.device).to(dt)
         - cam.cy) * _recip(cam.fy)
    pc = torch.stack([u[None, None, :] * ds, v[None, :, None] * ds, ds], -1)
    p = geo.transform_points(T_sm_cam.to(dt), pc)
    vox = torch.floor(p * (1.0 / g.voxel_size)).to(torch.int64)
    blk = torch.div(vox, g.voxels_per_side, rounding_mode="floor")
    h = g.grid_dim // 2
    ok = ((d > g.min_range) & (d < g.max_range))[None] & \
        (ds > g.min_range) & ((blk >= -h) & (blk < h)).all(-1)
    gc = blk + h
    cell = (gc[..., 0] * g.grid_dim + gc[..., 1]) * g.grid_dim + gc[..., 2]
    return torch.unique(cell[ok])[:min(g.max_touched_blocks, g.max_blocks)]


def _allocate(layer: Layer, cells: Tensor) -> Tensor:
    """Give the new cells the next rows in cell order → the rows of all
    ``cells`` (−1 where the pool is full)."""
    g = layer.g
    new = cells[layer.grid[cells] < 0]
    take = min(new.shape[0], g.max_blocks - layer.n)
    new = new[:take]
    rows = torch.arange(layer.n, layer.n + take, device=cells.device)
    layer.grid[new] = rows
    gd, h = g.grid_dim, g.grid_dim // 2
    layer.coords[rows] = torch.stack([new // (gd * gd), (new // gd) % gd,
                                      new % gd], -1) - h
    layer.n += take
    out = layer.grid[cells]
    return out[out >= 0]


def _update(layer: Layer, rows: Tensor, depth: Tensor, color: Tensor,
            T_sm_cam: Tensor, cam) -> None:
    g, dt = layer.g, layer.dtype
    vps = g.voxels_per_side
    r = torch.arange(vps, device=rows.device)
    ix, iy, iz = torch.meshgrid(r, r, r, indexing="ij")
    local = (torch.stack([ix, iy, iz], -1).reshape(-1, 3).to(dt) + 0.5) \
        * g.voxel_size
    centre = (layer.coords[rows].to(dt) * (g.voxel_size * vps))[:, None] \
        + local[None]
    pc = geo.transform_points(geo.inverse(T_sm_cam.to(dt)), centre)
    z = pc[..., 2]
    zs = torch.clamp(z, min=1e-6)
    uf = pc[..., 0] / zs * cam.fx + cam.cx
    vf = pc[..., 1] / zs * cam.fy + cam.cy
    ui = torch.round(uf).to(torch.int64)
    vi = torch.round(vf).to(torch.int64)
    inside = ((z > g.min_range) & (ui >= 0) & (ui < cam.width)
              & (vi >= 0) & (vi < cam.height))
    pix = torch.where(inside, vi * cam.width + ui, 0)
    d = depth.reshape(-1).to(dt)[pix]
    tau = g.truncation
    sdf = d - z
    obs = inside & (d > g.min_range) & (d < g.max_range) & (sdf > -tau)
    w_obs = torch.ones_like(sdf)
    if g.use_distance_weight:
        w_obs = w_obs / torch.clamp(d * d, min=1.0)
    if g.use_dropoff:
        w_obs = w_obs * torch.clamp((sdf + tau) * _recip(0.5 * tau),
                                    0.0, 1.0)
    w_obs = torch.where(obs, w_obs, 0.0)
    tie = inside & (d > g.min_range) & (d < g.max_range) & (
        ((torch.abs(torch.abs(uf - ui.to(dt)) - 0.5) < TIE_PX)
         | (torch.abs(torch.abs(vf - vi.to(dt)) - 0.5) < TIE_PX)
         | (torch.abs(torch.abs(sdf) - tau) < TIE_M)))
    layer.tie[rows] |= tie
    w_old, s_old = layer.weight[rows], layer.sdf[rows]
    new_w = torch.clamp(w_old + w_obs, max=g.max_weight)
    den = torch.clamp(new_w, min=1e-9)
    upd = new_w > 0
    layer.sdf[rows] = torch.where(
        upd, (w_old * s_old + w_obs * torch.clamp(sdf, -tau, tau)) / den,
        s_old)
    if color is not None:
        c_pix = color.reshape(-1, 3).to(dt)[pix].permute(0, 2, 1)
        near = (w_obs * (torch.abs(sdf) < tau))[:, None]
        c_old = layer.color[rows]
        layer.color[rows] = torch.where(
            upd[:, None], (w_old[:, None] * c_old + near * c_pix)
            / den[:, None], c_old)
    layer.weight[rows] = new_w


def integrate(layer: Layer, cam, depth: Tensor, color, T_sm_cam: Tensor):
    """One frame: depth (H, W), colour (H, W, 3) in [0, 1] or None, the
    camera's pose in the submap frame (7,)."""
    rows = _allocate(layer, _cells(layer.g, depth, T_sm_cam, cam,
                                   layer.dtype))
    if rows.numel():
        _update(layer, rows, depth, color, T_sm_cam, cam)


def touched_blocks(g: Grid, cam, depth: Tensor, T_sm_cam: Tensor) -> int:
    """Blocks a frame updates (the allocation's cells), for K1's bound."""
    return int(_cells(g, depth, T_sm_cam, cam, torch.float32).numel())
