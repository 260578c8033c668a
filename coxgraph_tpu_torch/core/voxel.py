"""Block-sparse TSDF voxel storage — port of ``coxgraph_tpu.core.voxel``.

Same layout as the reference:

* a fixed-capacity **block pool** of FLAT rows: ``sdf``/``weight``
  ``(max_blocks, vps³)`` and channel-planar ``color`` ``(max_blocks,
  3·vps³)``, voxels in C order (ix·vps² + iy·vps + iz);
* a dense **block index grid** ``(G, G, G) int32`` mapping a block
  coordinate (centered, range [-G/2, G/2)) to its pool slot, -1 when
  unallocated.

Allocation is bit-identical to the JAX package: the same candidates give
the same slots, ``block_coords`` and ``num_blocks``. ``allocate_cells``
returns unique slots at every live lane, which lets the block update
write pool rows without atomics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.tensorops import f32_reciprocal, scatter_drop

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class VoxelGridSpec:
    """Static geometry of a voxel layer (same fields and defaults as the
    JAX package's)."""

    voxel_size: float = 0.05
    voxels_per_side: int = 16
    grid_dim: int = 64
    max_blocks: int = 8192
    truncation: float = 0.15

    def __post_init__(self):
        if self.grid_dim % 2:
            raise ValueError(f"grid_dim must be even, got {self.grid_dim}")

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.voxels_per_side

    @property
    def half_grid(self) -> int:
        return self.grid_dim // 2


@dataclasses.dataclass
class TsdfLayer:
    """Block-sparse TSDF volume (dataclass of tensors).

    sdf/weight: (max_blocks, vps³) f32; color: (max_blocks, 3·vps³) f32 in
    [0, 1], planar [r, g, b]; block_index: (G,G,G) int32 slot or -1;
    block_coords: (max_blocks, 3) int32; num_blocks: () int32 watermark.
    A stacked collection carries a leading (S,) axis on every field."""

    sdf: Tensor
    weight: Tensor
    color: Tensor
    block_index: Tensor
    block_coords: Tensor
    num_blocks: Tensor

    @property
    def max_blocks(self) -> int:
        return self.sdf.shape[0]

    @property
    def voxels_per_side(self) -> int:
        return round(self.sdf.shape[1] ** (1.0 / 3.0))


def create_tsdf_layer(spec: VoxelGridSpec, device,
                      dtype=torch.float32) -> TsdfLayer:
    mb, v, g = spec.max_blocks, spec.voxels_per_side, spec.grid_dim
    return TsdfLayer(
        sdf=torch.full((mb, v * v * v), spec.truncation, dtype=dtype,
                       device=device),
        weight=torch.zeros((mb, v * v * v), dtype=dtype, device=device),
        color=torch.zeros((mb, 3 * v * v * v), dtype=dtype, device=device),
        block_index=torch.full((g, g, g), -1, dtype=torch.int32,
                               device=device),
        block_coords=torch.zeros((mb, 3), dtype=torch.int32, device=device),
        num_blocks=torch.zeros((), dtype=torch.int32, device=device),
    )


def memory_size_bytes(layer: TsdfLayer) -> int:
    """Total bytes of the pool tensors (cf. voxblox getMemorySize, the
    server's bandwidth accounting at coxgraph_server.cpp:281-285). Shapes
    and dtypes only: no device read."""
    return sum(x.numel() * x.element_size()
               for x in (layer.sdf, layer.weight, layer.color,
                         layer.block_index, layer.block_coords))


# ---------------------------------------------------------------------------
# Coordinate transforms
# ---------------------------------------------------------------------------


def point_to_voxel(spec: VoxelGridSpec, p: Tensor) -> Tensor:
    """World point (...,3) → global voxel index (...,3) int32 (floor)."""
    return torch.floor(p * f32_reciprocal(spec.voxel_size)).to(torch.int32)


def voxel_to_block(spec: VoxelGridSpec, v: Tensor):
    """Global voxel index → (block coord, local voxel index), both int32."""
    b = torch.div(v, spec.voxels_per_side, rounding_mode="floor")
    return b, v - b * spec.voxels_per_side


def block_in_grid(spec: VoxelGridSpec, b: Tensor) -> Tensor:
    """Mask (...,) — block coordinate falls inside the index grid."""
    h = spec.half_grid
    return ((b >= -h) & (b < h)).all(dim=-1)


def block_grid_slot(spec: VoxelGridSpec, b: Tensor) -> Tensor:
    """Block coordinate (...,3) → flat index into the block_index grid.
    Out-of-range coordinates are clamped; pair with block_in_grid."""
    h = spec.half_grid
    bc = torch.clamp(b + h, 0, spec.grid_dim - 1)
    return (bc[..., 0] * spec.grid_dim + bc[..., 1]) * spec.grid_dim \
        + bc[..., 2]


def block_origin(spec: VoxelGridSpec, b: Tensor) -> Tensor:
    """Block coordinate (...,3) int32 → world position of its min corner."""
    return b.to(torch.float32) * spec.block_size


def voxel_centers_of_block(spec: VoxelGridSpec, b: Tensor) -> Tensor:
    """(...,3) block coord → (..., vps,vps,vps, 3) world voxel centers."""
    v = spec.voxels_per_side
    r = torch.arange(v, dtype=torch.float32, device=b.device)
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    local = torch.stack([zz, yy, xx], dim=-1)  # index order (i,j,k)=(x,y,z)
    local = (local + 0.5) * spec.voxel_size
    return block_origin(spec, b)[..., None, None, None, :] + local


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def candidate_cells(spec: VoxelGridSpec, grid_slots: Tensor, valid: Tensor,
                    max_touched: int) -> Tensor:
    """Candidate compaction: the K smallest unique valid cell ids,
    ascending, padded with G³ → t_cells (K,) int32.

    Two sorts: sort the ids (invalid → G³), mark first occurrences, then
    sort again with the repeats sent to G³ and keep the first K. This
    equals the reference's ``-top_k(-ids)`` selection."""
    g3 = spec.grid_dim ** 3
    K = max_touched
    ids = torch.sort(torch.where(valid, grid_slots, g3)).values
    uniq = torch.cat([ids[:1] < g3,
                      (ids[1:] != ids[:-1]) & (ids[1:] < g3)])
    t_cells = torch.sort(torch.where(uniq, ids, g3)).values[:K]
    if t_cells.shape[0] < K:
        t_cells = torch.cat([t_cells, t_cells.new_full(
            (K - t_cells.shape[0],), g3)])
    return t_cells


def allocate_cells(spec: VoxelGridSpec, flat_index: Tensor,
                   block_coords: Tensor, num_blocks: Tensor,
                   t_cells: Tensor):
    """Sequential allocation half: look up the block index at the
    compacted cells, give new cells consecutive pool slots in cell order,
    return the touched slots.
    → (flat_index, block_coords, num_blocks, slots (K,), mask (K,)), the
    first three as new tensors.

    POSTCONDITION: ``slots`` are unique at every mask-True lane; masked
    lanes hold ``max_blocks``."""
    g3 = spec.grid_dim ** 3
    mb = spec.max_blocks
    t_mask = t_cells < g3

    fi_t = flat_index[torch.clamp(t_cells, max=g3 - 1).long()]
    is_new = t_mask & (fi_t < 0)

    rank = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    slot_id = num_blocks + rank
    can_alloc = is_new & (slot_id < mb)
    n_new = can_alloc.sum(dtype=torch.int32)
    new_flat = scatter_drop(flat_index, torch.where(can_alloc, t_cells, g3),
                            torch.where(can_alloc, slot_id, 0))
    gd = spec.grid_dim
    ncz = t_cells % gd
    ncy = (t_cells // gd) % gd
    ncx = t_cells // (gd * gd)
    coords_new = torch.stack([ncx, ncy, ncz], dim=-1) - spec.half_grid
    block_coords = scatter_drop(block_coords,
                                torch.where(can_alloc, slot_id, mb),
                                coords_new)
    num_blocks = num_blocks + n_new

    slots = torch.where(is_new, slot_id, fi_t)
    mask = t_mask & (slots >= 0) & (slots < mb)
    slots = torch.where(mask, slots, mb)
    return new_flat, block_coords, num_blocks, slots, mask


def allocate_and_slots(spec: VoxelGridSpec, flat_index: Tensor,
                       block_coords: Tensor, num_blocks: Tensor,
                       grid_slots: Tensor, valid: Tensor, max_touched: int):
    """Fused allocation + touched-slot compaction: candidate_cells then
    allocate_cells. Allocation caps at max_touched new cells among the K
    smallest touched; overflow cells stay unallocated for later frames.
    → (flat_index, block_coords, num_blocks, slots (K,), mask (K,))."""
    t_cells = candidate_cells(spec, grid_slots, valid, max_touched)
    return allocate_cells(spec, flat_index, block_coords, num_blocks,
                          t_cells)


def allocate_blocks(spec: VoxelGridSpec, layer: TsdfLayer,
                    block_coords: Tensor,
                    mask: Optional[Tensor] = None) -> TsdfLayer:
    """Ensure every (masked) block coordinate (N,3) int32, duplicates
    allowed, has a pool slot → a layer with new ``block_index``,
    ``block_coords`` and ``num_blocks`` (the pools are shared with
    ``layer``). New blocks take consecutive slots in grid-cell order;
    blocks past the pool's capacity are dropped. This is candidate_cells
    with room for every candidate, then allocate_cells."""
    g3 = spec.grid_dim ** 3
    valid = block_in_grid(spec, block_coords)
    if mask is not None:
        valid = valid & mask
    t_cells = candidate_cells(spec, block_grid_slot(spec, block_coords),
                              valid, block_coords.shape[0])
    flat, coords, nb, _, _ = allocate_cells(
        spec, layer.block_index.reshape(g3), layer.block_coords,
        layer.num_blocks, t_cells)
    return dataclasses.replace(
        layer, block_index=flat.reshape(layer.block_index.shape),
        block_coords=coords, num_blocks=nb)


# ---------------------------------------------------------------------------
# Lookup / sampling
# ---------------------------------------------------------------------------


def lookup_block(spec: VoxelGridSpec, layer: TsdfLayer, b: Tensor) -> Tensor:
    """Block coordinate (...,3) → pool slot (...,) int32 (-1 if missing)."""
    slot = block_grid_slot(spec, b)
    idx = layer.block_index.reshape(-1)[slot.long()]
    return torch.where(block_in_grid(spec, b), idx, -1)


def voxel_lookup(spec: VoxelGridSpec, layer: TsdfLayer, v: Tensor):
    """Global voxel index (...,3) → (sdf, weight, valid); a voxel of a
    missing block reads (truncation, 0, False)."""
    b, lv = voxel_to_block(spec, v)
    idx = lookup_block(spec, layer, b)
    vps = spec.voxels_per_side
    lin = (lv[..., 0] * vps + lv[..., 1]) * vps + lv[..., 2]
    valid = idx >= 0
    flat = torch.where(valid, idx.long() * vps ** 3 + lin, 0)
    sdf = layer.sdf.reshape(-1)[flat]
    w = layer.weight.reshape(-1)[flat]
    return (torch.where(valid, sdf, spec.truncation),
            torch.where(valid, w, 0.0), valid)


def shift(v: Tensor, off) -> Tensor:
    """v (...,3) + a constant (dx, dy, dz), with no host-to-device copy
    of the constant."""
    return torch.stack([v[..., a] + off[a] for a in range(3)], dim=-1)


def trilinear_base(spec: VoxelGridSpec, p: Tensor):
    """Voxel centres sit at (v + 0.5)·s, so the trilinear base voxel of
    world points p (...,3) is floor(p/s − 0.5) → (base (...,3) int32,
    frac (...,3))."""
    x = p * f32_reciprocal(spec.voxel_size) - 0.5
    v0 = torch.floor(x).to(torch.int32)
    return v0, x - v0.to(x.dtype)


def trilinear_corners(spec: VoxelGridSpec, p: Tensor):
    """Trilinear setup at world points p (...,3) → (base voxel (...,3)
    int32, [(corner offset (dx, dy, dz), weight (...,))] × 8 in the
    reference's corner order)."""
    v0, frac = trilinear_base(spec, p)
    f = [frac[..., a] for a in range(3)]
    corners = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wt = ((f[0] if dx else 1 - f[0]) * (f[1] if dy else 1 - f[1])
                      * (f[2] if dz else 1 - f[2]))
                corners.append(((dx, dy, dz), wt))
    return v0, corners


def sample_tsdf_trilinear(spec: VoxelGridSpec, layer: TsdfLayer, p: Tensor):
    """Trilinear TSDF interpolation at world points p (...,3) → (sdf,
    weight, valid); valid needs all 8 corner voxels allocated and
    observed (weight > 0)."""
    v0, corners = trilinear_corners(spec, p)
    sdf_acc = torch.zeros(p.shape[:-1], dtype=layer.sdf.dtype,
                          device=p.device)
    w_acc = torch.zeros_like(sdf_acc)
    valid = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for off, wt in corners:
        s, w, ok = voxel_lookup(spec, layer, shift(v0, off))
        sdf_acc = sdf_acc + wt * s
        w_acc = w_acc + wt * w
        valid = valid & ok & (w > 0)
    return sdf_acc, w_acc, valid


def sample_tsdf_gradient(spec: VoxelGridSpec, layer: TsdfLayer, p: Tensor,
                         delta: Optional[float] = None):
    """Central-difference TSDF gradient at world points (...,3) → (grad
    (...,3), valid): six trilinear samples at p ± delta along each axis
    (delta defaults to the voxel size)."""
    d = spec.voxel_size if delta is None else delta
    grads = []
    valid = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for axis in range(3):
        off = [d if a == axis else 0.0 for a in range(3)]
        sp, _, vp = sample_tsdf_trilinear(spec, layer, shift(p, off))
        sm, _, vm = sample_tsdf_trilinear(
            spec, layer, shift(p, [-o for o in off]))
        grads.append((sp - sm) * f32_reciprocal(2 * d))
        valid = valid & vp & vm
    return torch.stack(grads, dim=-1), valid
