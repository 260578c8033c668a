"""Mesh postprocessing — port of ``coxgraph_tpu.ops.mesh_post``, the
ServerVisualizer's Open3D pipeline
(reference: server_visualizer.cpp:67-121 — MergeCloseVertices(0.06) →
RemoveDuplicatedVertices → RemoveDuplicatedTriangles →
FilterSmoothTaubin(100) → SimplifyVertexClustering(0.05) on the combined
global mesh before export).

Host-side CPU by design: SURVEY.md §2.9 notes the Open3D postprocess is a
host-side export path (it runs once per final-mesh service call, not in the
frame hot loop), so vectorized numpy — np.unique clustering + bincount
Laplacians — replaces Open3D. The device side already front-compacts the
triangle soup (ops/mesh.py), so this stage sees only real triangles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class IndexedMesh:
    """Shared-vertex triangle mesh (the Open3D TriangleMesh equivalent)."""

    vertices: np.ndarray           # (V,3) f32
    faces: np.ndarray              # (F,3) i32
    colors: Optional[np.ndarray]   # (V,3) f32 in [0,1] or None

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])


def connect_soup(tri_verts: np.ndarray,
                 tri_colors: Optional[np.ndarray] = None,
                 decimals: int = 5) -> IndexedMesh:
    """Triangle soup (T,3,3) → indexed mesh with exact-position vertex
    sharing (RemoveDuplicatedVertices on the raw soup)."""
    tri_verts = np.asarray(tri_verts, np.float32)
    flat = tri_verts.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=decimals), axis=0,
                          return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    colors = None
    if tri_colors is not None:
        colors = _average_by_cluster(
            np.asarray(tri_colors, np.float32).reshape(-1, 3), inv,
            uniq.shape[0])
    return IndexedMesh(uniq.astype(np.float32), faces, colors)


def _average_by_cluster(values: np.ndarray, cluster: np.ndarray,
                        n_clusters: int) -> np.ndarray:
    """Per-cluster mean of (N,K) values under labels (N,) → (C,K)."""
    cnt = np.maximum(np.bincount(cluster, minlength=n_clusters), 1)
    out = np.empty((n_clusters, values.shape[1]), np.float64)
    for k in range(values.shape[1]):
        out[:, k] = np.bincount(cluster, weights=values[:, k],
                                minlength=n_clusters)
    return (out / cnt[:, None]).astype(np.float32)


def _remap_faces(mesh: IndexedMesh, cluster: np.ndarray,
                 new_verts: np.ndarray,
                 new_colors: Optional[np.ndarray]) -> IndexedMesh:
    """Apply a vertex clustering: remap faces, drop degenerates + dups."""
    faces = cluster[mesh.faces]
    keep = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[keep]
    faces = remove_duplicated_triangles(faces)
    return IndexedMesh(new_verts, faces.astype(np.int32), new_colors)


def merge_close_vertices(mesh: IndexedMesh, radius: float) -> IndexedMesh:
    """Cluster vertices on a grid of cell size `radius` and snap each
    cluster to its centroid (MergeCloseVertices(0.06) equivalent —
    Open3D likewise buckets by a regular grid)."""
    if mesh.n_vertices == 0 or radius <= 0:
        return mesh
    cells = np.floor(mesh.vertices / radius).astype(np.int64)
    _, cluster, counts = np.unique(cells, axis=0, return_inverse=True,
                                   return_counts=True)
    n = counts.shape[0]
    new_verts = _average_by_cluster(mesh.vertices, cluster, n)
    new_colors = (None if mesh.colors is None
                  else _average_by_cluster(mesh.colors, cluster, n))
    return _remap_faces(mesh, cluster, new_verts, new_colors)


def remove_duplicated_triangles(faces: np.ndarray) -> np.ndarray:
    """Drop faces that reference the same vertex set (orientation-agnostic,
    like Open3D RemoveDuplicatedTriangles)."""
    if faces.shape[0] == 0:
        return faces
    key = np.sort(faces, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    return faces[np.sort(first)]


def _adjacency_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges (E,2) of the face list."""
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def taubin_smooth(mesh: IndexedMesh, iterations: int = 100,
                  lam: float = 0.5, mu: float = -0.53) -> IndexedMesh:
    """Taubin λ|μ smoothing (FilterSmoothTaubin(100) equivalent): alternate
    a shrink step (λ) and an inflate step (μ) of the uniform-Laplacian
    flow, which smooths without the volume loss of plain Laplacian
    filtering. Vectorized via per-coordinate bincount scatter-adds."""
    if mesh.n_vertices == 0 or iterations <= 0:
        return mesh
    edges = _adjacency_edges(mesh.faces)
    if edges.shape[0] == 0:
        return mesh
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    v = mesh.n_vertices
    deg = np.bincount(src, minlength=v).astype(np.float32)
    deg_safe = np.maximum(deg, 1.0)[:, None]
    verts = mesh.vertices.astype(np.float64).copy()

    def laplacian(x):
        nbr = np.empty_like(x)
        for k in range(3):
            nbr[:, k] = np.bincount(src, weights=x[dst, k], minlength=v)
        return nbr / deg_safe - x

    for _ in range(iterations):
        verts = verts + lam * laplacian(verts)
        verts = verts + mu * laplacian(verts)
    # isolated vertices (deg 0) stay put: laplacian is -x there; guard them
    iso = deg == 0
    verts[iso] = mesh.vertices[iso]
    return IndexedMesh(verts.astype(np.float32), mesh.faces, mesh.colors)


def simplify_vertex_clustering(mesh: IndexedMesh,
                               voxel_size: float) -> IndexedMesh:
    """Collapse all vertices in each voxel to their centroid
    (SimplifyVertexClustering(0.05) equivalent)."""
    return merge_close_vertices(mesh, voxel_size)


def postprocess(tri_verts: np.ndarray,
                tri_colors: Optional[np.ndarray] = None,
                merge_radius: float = 0.06,
                taubin_iterations: int = 100,
                simplify_voxel: float = 0.05) -> IndexedMesh:
    """The full reference pipeline on a device-extracted triangle soup."""
    mesh = connect_soup(tri_verts, tri_colors)
    mesh = merge_close_vertices(mesh, merge_radius)
    mesh.faces = remove_duplicated_triangles(mesh.faces)
    mesh = taubin_smooth(mesh, taubin_iterations)
    mesh = simplify_vertex_clustering(mesh, simplify_voxel)
    return mesh
