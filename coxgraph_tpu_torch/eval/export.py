"""Mesh / trajectory export — port of ``coxgraph_tpu.eval.export`` (the
reference's PLY + TUM outputs, server_visualizer.cpp:60-141,
coxgraph_server.cpp:165-179, coxgraph_client.cpp:193-210). Host numpy,
the same code as the JAX package's: the same inputs write the same bytes.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, tri_verts: np.ndarray,
              tri_colors: np.ndarray | None = None) -> int:
    """Write a triangle-soup mesh to binary-little-endian PLY.

    tri_verts: (T,3,3) float; tri_colors: (T,3,3) in [0,1] or None.
    Vertices are deduplicated by exact position so the file carries shared
    vertices + an index list (like voxblox's connected mesh output).
    Returns the number of unique vertices written."""
    tri_verts = np.asarray(tri_verts, dtype=np.float32)
    flat = tri_verts.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=5), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    has_color = tri_colors is not None
    if has_color:
        cols = np.zeros((uniq.shape[0], 3), dtype=np.float64)
        cnt = np.zeros((uniq.shape[0], 1), dtype=np.float64)
        flat_c = np.asarray(tri_colors, dtype=np.float64).reshape(-1, 3)
        np.add.at(cols, inv, flat_c)
        np.add.at(cnt, inv, 1.0)
        cols = (255.0 * cols / np.maximum(cnt, 1.0)).clip(0, 255).astype(np.uint8)

    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {uniq.shape[0]}",
               "property float x", "property float y", "property float z"]
        if has_color:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {faces.shape[0]}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if has_color:
            rec = np.zeros(uniq.shape[0],
                           dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = uniq
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(uniq.astype("<f4").tobytes())
        frec = np.zeros(faces.shape[0], dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
    return int(uniq.shape[0])


def write_ply_indexed(path: str, vertices: np.ndarray, faces: np.ndarray,
                      vertex_colors: np.ndarray | None = None) -> int:
    """Write an already-indexed mesh (e.g. ops.mesh_post.IndexedMesh output)
    to binary PLY. vertices (V,3) f32, faces (F,3) i32, vertex_colors (V,3)
    in [0,1] or None. Returns V."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    has_color = vertex_colors is not None
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {vertices.shape[0]}",
               "property float x", "property float y", "property float z"]
        if has_color:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {faces.shape[0]}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if has_color:
            cols = (255.0 * np.asarray(vertex_colors, np.float64)).clip(
                0, 255).astype(np.uint8)
            rec = np.zeros(vertices.shape[0],
                           dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = vertices
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        frec = np.zeros(faces.shape[0], dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
    return int(vertices.shape[0])


def read_ply_counts(path: str):
    """Parse a PLY header → (n_vertices, n_faces) for sanity checks."""
    nv = nf = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode(errors="ignore").strip()
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
            elif line == "end_header":
                break
    return nv, nf


def write_tum_trajectory(path: str, stamps: np.ndarray, poses: np.ndarray):
    """TUM format: t x y z qx qy qz qw (reference writes the same order,
    coxgraph_server.cpp:165-179). poses: (N,7) [qw qx qy qz tx ty tz]."""
    stamps = np.asarray(stamps)
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for t, p in zip(stamps, poses):
            qw, qx, qy, qz, x, y, z = p
            f.write(f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def read_tum_trajectory(path: str):
    """→ (stamps (N,), poses (N,7) [qw qx qy qz tx ty tz])."""
    rows = np.loadtxt(path).reshape(-1, 8)
    stamps = rows[:, 0]
    poses = np.stack(
        [rows[:, 7], rows[:, 4], rows[:, 5], rows[:, 6],
         rows[:, 1], rows[:, 2], rows[:, 3]], axis=-1
    )
    return stamps, poses
