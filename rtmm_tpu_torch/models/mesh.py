"""Host-side micro-mesh data model.

Equivalent of the reference's CPU mesh structures
(framework/include/framework/mesh.h:13-65): a coarse base
mesh where every base triangle carries a triangular grid of displaced
micro-vertices plus the micro-face index list. Differences from the
reference are deliberate TPU-first choices:

  - per-triangle micro data is dense NumPy (grid storage order
    x*(x+1)/2 + y) instead of std::vector-of-structs;
  - `direction` is stored per base vertex exactly like the reference
    (mesh.h:29-35), recovered by the loader / generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import subdivision


@dataclasses.dataclass
class MicroTriangle:
    """One base triangle (reference `Triangle`, mesh.h:19-27)."""

    base_vertex_indices: np.ndarray   # (3,) int32 into MicroMesh.positions
    u_positions: np.ndarray           # (M, 3) f32 undisplaced micro-vertex pos
    u_displacements: np.ndarray       # (M, 3) f32 displacement vectors
    u_present: np.ndarray             # (M,) bool (mesh.h:16)
    u_faces: np.ndarray               # (F, 3) int32 into the micro-vertex grid

    @property
    def subdivision_level(self) -> int:
        """Subdivision level of this triangle's micro-vertex grid.

        Derived from the vertex-grid size rather than the reference's
        ceil(log2(#uFaces)/2) (mesh.cpp:115-117): a level-1 triangle whose
        three edge midpoints are all absent stitches to a single face, which
        the face-count formula would misreport as level 0 even though the
        grid stores 6 vertices.
        """
        return subdivision.level_from_vertex_count(self.u_positions.shape[0])

    @property
    def n_rows(self) -> int:
        """Micro-vertices on one edge (mesh.cpp:97-113, via grid size here)."""
        return subdivision.rows_for_level(
            subdivision.level_from_vertex_count(self.u_positions.shape[0]))


@dataclasses.dataclass
class MicroMesh:
    """Reference `Mesh` (mesh.h:37-65)."""

    positions: np.ndarray    # (V, 3) f32 base vertex positions
    normals: np.ndarray      # (V, 3) f32 base vertex normals
    directions: np.ndarray   # (V, 3) f32 displacement directions
    triangles: list[MicroTriangle]

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def subdivision_levels(self) -> np.ndarray:
        """(T,) int64 subdivision level of every triangle, read from the
        vertex-grid sizes (one level_from_vertex_count per distinct size)."""
        counts = np.fromiter((t.u_positions.shape[0] for t in self.triangles),
                             np.int64, len(self.triangles))
        sizes, inv = np.unique(counts, return_inverse=True)
        per_size = np.array([subdivision.level_from_vertex_count(int(c))
                             for c in sizes], np.int64)
        return per_size[inv.reshape(-1)]

    @property
    def max_level(self) -> int:
        return int(self.subdivision_levels().max(initial=0))

    def has_uniform_subdivision_level(self) -> bool:
        """mesh.cpp:422-424."""
        return np.unique(self.subdivision_levels()).shape[0] <= 1

    def all_present(self) -> bool:
        """Every micro-vertex of every triangle is present (no stitching);
        each distinct presence array is read once."""
        masks = {id(t.u_present): t.u_present for t in self.triangles}
        return all(bool(m.all()) for m in masks.values())

    def base_triangle_indices(self) -> np.ndarray:
        """(T, 3) int32 (mesh.cpp:31-35)."""
        return np.stack([t.base_vertex_indices for t in self.triangles]).astype(
            np.int32)

    def validate(self) -> None:
        """Sanity checks the reference implicitly assumes.

        In particular adjacent subdivision levels must differ by at most one
        (the micromesh constraint the reference's internal-level traversal
        relies on, intersection.hlsl:339-376). An edge is the sorted pair of
        its base vertices; the first offending edge in triangle order is
        reported. A vertex grid that is no level's raises in
        subdivision_levels.
        """
        levels = self.subdivision_levels()
        if levels.shape[0]:
            edges, _, first, count, low, high = edge_levels(
                self.base_triangle_indices(), levels)
            bad = (count == 2) & (high - low > 1)
            if bad.any():
                a, b = edges[first[bad].min()]
                raise ValueError("adjacent subdivision levels differ by >1 "
                                 f"on edge {(int(a), int(b))}")

    def all_triangles(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tessellation expansion with dedup (mesh.cpp:54-95).

        Returns (positions (N,3), normals (N,3), faces (F,3)): displaced
        micro-vertex positions, barycentrically interpolated base normals,
        and the flat index buffer. Dedup key is the exact bit pattern of
        (position, normal, direction=displacement), matching the reference's
        VertexHash + Vertex::operator== (mesh.cpp:10-29,74-87).
        """
        cache: dict[bytes, int] = {}
        out_pos: list[np.ndarray] = []
        out_nrm: list[np.ndarray] = []
        out_faces: list[list[int]] = []
        for t in self.triangles:
            bidx = t.base_vertex_indices
            a, b, c = (self.positions[bidx[0]], self.positions[bidx[1]],
                       self.positions[bidx[2]])
            na, nb, nc = (self.normals[bidx[0]], self.normals[bidx[1]],
                          self.normals[bidx[2]])
            bc = barycentric_coords(a, b, c, t.u_positions)     # (M, 3)
            pos = (t.u_positions + t.u_displacements).astype(np.float32)
            nrm = (bc[:, :1] * na + bc[:, 1:2] * nb + bc[:, 2:3] * nc).astype(
                np.float32)
            for face in t.u_faces:
                tri = []
                for vi in face:
                    key = (pos[vi].tobytes() + nrm[vi].tobytes()
                           + t.u_displacements[vi].astype(np.float32).tobytes())
                    if key not in cache:
                        cache[key] = len(out_pos)
                        out_pos.append(pos[vi])
                        out_nrm.append(nrm[vi])
                    tri.append(cache[key])
                out_faces.append(tri)
        return (np.asarray(out_pos, dtype=np.float32).reshape(-1, 3),
                np.asarray(out_nrm, dtype=np.float32).reshape(-1, 3),
                np.asarray(out_faces, dtype=np.int32).reshape(-1, 3))


def edge_levels(faces: np.ndarray, levels: np.ndarray):
    """The base edges of faces (F, 3) with per-face levels (F,): edge k of
    face f is (f0, f1), (f1, f2), (f2, f0) for k = 0, 1, 2, as the sorted
    pair of its base vertices. Returns (edges (3F, 2) in face-major
    order, group (3F,) the index of each one's distinct edge, first (E,)
    the first of each distinct edge in that order, count (E,) how often
    it occurs, low / high (E,) the least / greatest level of the faces
    that hold it)."""
    faces = np.asarray(faces, dtype=np.int64)
    levels = np.asarray(levels, dtype=np.int64)
    edges = np.sort(np.stack([faces[:, [0, 1]], faces[:, [1, 2]],
                              faces[:, [2, 0]]], axis=1),
                    axis=-1).reshape(-1, 2)
    key = edges[:, 0] * (int(faces.max(initial=0)) + 1) + edges[:, 1]
    _, first, group, count = np.unique(key, return_index=True,
                                       return_inverse=True,
                                       return_counts=True)
    group = group.reshape(-1)
    edge_lvl = np.repeat(levels, 3)
    low = np.full(count.shape[0], np.iinfo(np.int64).max, np.int64)
    high = np.full(count.shape[0], np.iinfo(np.int64).min, np.int64)
    np.minimum.at(low, group, edge_lvl)
    np.maximum.at(high, group, edge_lvl)
    return edges, group, first, count, low, high


def barycentric_coords(a: np.ndarray, b: np.ndarray, c: np.ndarray,
                       points: np.ndarray) -> np.ndarray:
    """Barycentric coords of `points` w.r.t. triangle (a, b, c).

    Vectorized port of Triangle::computeBaryCoords (mesh.cpp:37-52).
    points: (..., 3) -> (..., 3) [alpha, beta, gamma].
    """
    v0 = (b - a).astype(np.float64)
    v1 = (c - a).astype(np.float64)
    v2 = (points - a).astype(np.float64)
    d00 = np.dot(v0, v0)
    d01 = np.dot(v0, v1)
    d11 = np.dot(v1, v1)
    d20 = v2 @ v0
    d21 = v2 @ v1
    denom = d00 * d11 - d01 * d01
    beta = (d11 * d20 - d01 * d21) / denom
    gamma = (d00 * d21 - d01 * d20) / denom
    alpha = 1.0 - beta - gamma
    return np.stack([alpha, beta, gamma], axis=-1)
