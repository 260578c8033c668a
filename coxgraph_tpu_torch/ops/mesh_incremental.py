"""Incremental (changed-blocks-only) meshing — port of
``coxgraph_tpu.ops.mesh_incremental``.

Block chunks are the re-mesh unit. The integrators OR the slots they
update into ``MapperState.mesh_dirty``; ``mesh.dirty_block_chunks``
expands that to the mesh-dependent set and reduces it to per-chunk bits
on the device; the host reads the bits back and re-extracts just those
chunks (``mesh.extract_mesh_chunks_device``), whose runs refresh a
host-side per-chunk cache. A 1-block update re-meshes O(1) chunks.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import voxel as vx
from . import mesh as mesh_ops


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


class IncrementalMesher:
    """Per-chunk cached triangle soup with dirty-driven refresh.

    The cache maps chunk id → (verts (n,3,3) f32, colors (n,3,3) f32) in
    the layer's (submap) frame; ``update`` re-meshes exactly the chunks
    an updated-block bitmap invalidates and ``mesh`` concatenates the
    cached runs in chunk order — the content of ``extract_mesh`` of the
    same layer.

    quantize=True moves each update's triangles as uint16 vertices and
    uint8 colours (≤ extent/65535 position error); False equals
    ``extract_mesh(quantize=False)`` exactly.

    ``pending`` holds a dirty row that ``HostMapper.live_mesh_async``
    consumed for a dispatch whose ``finish()`` has not run yet; the next
    dispatch ORs it in, so a dropped ``finish()`` loses no update.
    """

    def __init__(self, spec: vx.VoxelGridSpec, chunk: int = 16,
                 min_weight: float = 1e-4, max_tris: int = 500_000,
                 quantize: bool = True):
        self.spec = spec
        self.chunk = chunk
        self.min_weight = float(min_weight)
        self.max_tris = max_tris
        self.quantize = quantize
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.pending: Optional[torch.Tensor] = None
        self.n_updates = 0
        self.chunks_remeshed = 0          # lifetime counter
        self.dropped_tris = 0             # only at maximum capacity
        # self-heal observability (silent growth, no data loss)
        self.cap_mult = 1                 # per-chunk capacity multiplier
        self.capacity_growths = 0         # cap_mult escalations
        self.buffer_growths = 0           # max_tris escalations

    # -- update -----------------------------------------------------------

    def update(self, layer: vx.TsdfLayer, updated: torch.Tensor
               ) -> List[int]:
        """Re-mesh the chunks invalidated by ``updated`` ((max_blocks,)
        bool on the layer's device, e.g. a consume_mesh_dirty row) against
        ``layer``. Returns the chunk ids re-meshed (empty = no change)."""
        chunk_dirty = mesh_ops.dirty_block_chunks(
            self.spec, layer, updated, self.chunk).cpu().numpy()
        ids = [int(i) for i in np.nonzero(chunk_dirty)[0]]
        self.refresh_chunks(ids, layer)
        return ids

    def refresh_chunks(self, ids: List[int], layer: vx.TsdfLayer) -> None:
        """Re-extract the given chunks and refresh the cache (chunks whose
        geometry vanished are dropped).

        Capacity heals itself: a full triangle buffer grows ``max_tris``
        to the true need and a chunk overflowing its capacity escalates
        ``cap_mult`` (pow2, ≤ 16), each redoing the update in the same call
        (counters ``buffer_growths`` / ``capacity_growths``). Growth is
        sticky."""
        if not ids:
            return
        device = layer.sdf.device
        chunk_ids = torch.as_tensor(np.asarray(ids, np.int32),
                                    device=device)
        t_chunk = self.chunk * (self.spec.voxels_per_side ** 3) * 12
        for _ in range(12):   # bounded; every retry strictly grows capacity
            verts, cols, offs, cnts, totals = \
                mesh_ops.extract_mesh_chunks_device(
                    self.spec, layer, self.chunk, self.min_weight,
                    self.max_tris, chunk_ids, cap_mult=self.cap_mult)
            # one readback for the three small per-chunk tables
            offs_h, cnts_h, totals_h = torch.stack(
                [offs, cnts, totals]).cpu().numpy().astype(np.int64)
            # true buffer end = max over chunks (the last chunk may be
            # empty, and on overflow the clamped offset parks at max_tris)
            used = int((offs_h + cnts_h).max())
            if used > self.max_tris:
                # later chunks overlapped the tail: grow and redo (totals
                # is pre-clamp, so its sum bounds the true need)
                self.max_tris = 1 << max(int(totals_h.sum()) - 1,
                                         1).bit_length()
                self.buffer_growths += 1
                continue
            if int(np.maximum(totals_h - cnts_h, 0).max()) > 0 \
                    and self.cap_mult < 16:
                # a chunk overflowed: escalate to cover the densest one
                need = -(-int(totals_h.max()) * 16 // t_chunk)
                self.cap_mult = min(16, _next_pow2(
                    max(need, 2 * self.cap_mult)))
                self.capacity_growths += 1
                continue
            break
        dropped = int(np.maximum(totals_h - cnts_h, 0).sum())
        if dropped:   # only reachable at cap_mult == 16 (cap == t_chunk)
            self.dropped_tris += dropped
            warnings.warn(
                f"incremental mesh update dropped {dropped} triangles at "
                "maximum per-chunk capacity", RuntimeWarning, stacklevel=3)
        if used:
            if self.quantize:
                qv, qc, mn, scale = mesh_ops.quantize_mesh_device(
                    self.spec, layer, verts, cols)
                vflat, cflat = mesh_ops.host_triangles(
                    qv, qc, used, mesh_ops.host_quant(mn, scale))
            else:
                vflat, cflat = mesh_ops.host_triangles(verts, cols, used)
        for i, cid in enumerate(ids):
            n = int(cnts_h[i])
            if n == 0:
                self._cache.pop(cid, None)
                continue
            o = int(offs_h[i])
            self._cache[cid] = (vflat[o:o + n].copy(),
                                cflat[o:o + n].copy())
        self.n_updates += 1
        self.chunks_remeshed += len(ids)

    def full_rebuild(self, layer: vx.TsdfLayer) -> None:
        """Rebuild every chunk's cache, sized off ``layer.max_blocks`` (a
        grown merged layer carries a larger pool than the spec)."""
        self._cache.clear()
        n_chunks = -(-layer.max_blocks // self.chunk)
        self.refresh_chunks(list(range(n_chunks)), layer)

    # -- queries ----------------------------------------------------------

    def mesh(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full cached soup → (verts (T,3,3), colors (T,3,3)) f32, chunks
        concatenated in id order (the extract_mesh chunk order)."""
        if not self._cache:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z.copy()
        parts = [self._cache[c] for c in sorted(self._cache)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def chunk_mesh(self, cid: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One chunk's cached run (None if it holds no triangles) — the
        per-block delta unit for streaming."""
        return self._cache.get(cid)

    @property
    def n_triangles(self) -> int:
        return sum(v.shape[0] for v, _ in self._cache.values())
