"""Procedural micro-mesh asset generation.

The reference repository ships no assets (inputs come from NVIDIA's
micromesh-tools, README.md:8-14). For tests and benchmarks we synthesize
micro-meshes with the same structure the reference loader produces
(TinyGLTFLoader.cpp:26-89): per base triangle a power-of-two triangular grid
of micro-vertices whose displacement is `scale * interpolated base direction`,
with presence-driven stitching against lower-level neighbors.
"""
from __future__ import annotations

import numpy as np

from ..ops import subdivision
from . import mesh as mesh_mod


def _default_height(p: np.ndarray, amplitude: float) -> np.ndarray:
    """Smooth multi-frequency height field (keeps displacement scales smooth)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return amplitude * (
        0.55 * np.sin(3.1 * x + 1.3) * np.cos(2.7 * y - 0.4)
        + 0.3 * np.sin(6.3 * y + 2.0 * z)
        + 0.15 * np.cos(9.1 * (x + y + 0.5 * z)))


# Faces per batch of the level-wise build (bounds the float64 temporaries
# to a few hundred MiB at any level).
_FACE_CHUNK = 1 << 16


def _lower_neighbour_edges(faces: np.ndarray,
                           levels: np.ndarray) -> np.ndarray:
    """(F, 3) bool: edge k of face f ((f0, f1), (f1, f2), (f2, f0)) is
    shared by exactly two faces and the lower of their levels is the
    face's own minus one (the stitching rule, TinyGLTFLoader.cpp:59-79)."""
    _, group, _, count, low, _ = mesh_mod.edge_levels(faces, levels)
    face_lvl = np.repeat(levels, 3)
    return ((count[group] == 2) & (low[group] == face_lvl - 1)).reshape(-1, 3)


def _presence(lvl: int, lower: tuple[bool, bool, bool]) -> np.ndarray:
    """(M,) presence of a level-lvl grid whose edges flagged in `lower`
    border a lower-level neighbour: the finest-level (odd) vertices on
    those edges are absent (mesh.h:16, TinyGLTFLoader.cpp:59-79)."""
    n = subdivision.rows_for_level(lvl)
    coords = subdivision.grid_coords(lvl)
    denom = max(n - 1, 1)
    present = np.ones(coords.shape[0], dtype=bool)
    if n > 2:
        edge_specs = (  # (verts on that edge, position along)
            (coords[:, 1] == 0, coords[:, 0]),
            (coords[:, 0] == denom, coords[:, 1]),
            (coords[:, 0] == coords[:, 1], coords[:, 0]),
        )
        for flag, (on_edge, along) in zip(lower, edge_specs):
            if flag:
                present &= ~(on_edge & (along % 2 == 1))
    return present


def _leaf_faces(lvl: int, present: np.ndarray) -> np.ndarray:
    """Leaf enumeration with stitching == the tessellation uFaces, so the
    tessellated ground truth and the traversal see identical geometry."""
    denom = max(subdivision.rows_for_level(lvl) - 1, 1)
    fine = 2 ** lvl
    step = denom // fine if fine else 1

    def present_at(c):
        return present[subdivision.grid_index(c * step)]

    _, corners = subdivision.enumerate_leaves(lvl, present_at)
    return subdivision.grid_index(corners * step).astype(np.int32)


def _build_micromesh(positions: np.ndarray, normals: np.ndarray,
                     faces: np.ndarray, levels: np.ndarray,
                     amplitude: float, height_fn=None) -> mesh_mod.MicroMesh:
    """Assemble a MicroMesh from a base mesh + per-face subdivision levels.

    Built level by level over arrays: the barycentric grid once per level,
    positions and displacements for a batch of faces at once, and the
    presence mask and leaf faces once per (level, stitched-edge pattern),
    shared by every face of that class. Each value is the one the
    per-face construction gives: u_pos is (bc0*v0 + bc1*v1) + bc2*v2 in
    float64 cast to float32, heights go through the same ufuncs.
    height_fn maps (..., 3) float32 points to (...) heights.
    """
    positions = positions.astype(np.float32)
    normals = normals.astype(np.float32)
    directions = normals.copy()          # displace along vertex normals
    height_fn = height_fn or (lambda p: _default_height(p, amplitude))
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    levels = np.asarray(levels, dtype=np.int64).reshape(-1)
    faces32 = faces.astype(np.int32)
    pattern = _lower_neighbour_edges(faces, levels) @ np.array([1, 2, 4])

    tris: list = [None] * faces.shape[0]
    for lvl in np.unique(levels).tolist():
        n = subdivision.rows_for_level(lvl)
        coords = subdivision.grid_coords(lvl)               # (M, 2)
        denom = max(n - 1, 1)
        u = coords[:, 0] / denom
        w = coords[:, 1] / denom
        bc = np.stack([1.0 - u, u - w, w], axis=1)          # (M, 3)
        b0, b1, b2 = bc[None, :, :1], bc[None, :, 1:2], bc[None, :, 2:3]
        ids = np.nonzero(levels == lvl)[0]
        codes = np.unique(pattern[ids]).tolist()
        shared = [None] * len(codes)
        for k, code in enumerate(codes):
            present = _presence(lvl, tuple(bool(code >> e & 1)
                                           for e in range(3)))
            shared[k] = (present, _leaf_faces(lvl, present))
        presence = np.stack([present for present, _ in shared])
        slot = np.searchsorted(codes, pattern[ids])
        for s in range(0, ids.shape[0], _FACE_CHUNK):
            sel = ids[s:s + _FACE_CHUNK]
            f = faces[sel]
            v0, v1, v2 = (positions[f[:, k]][:, None, :] for k in range(3))
            d0, d1, d2 = (directions[f[:, k]][:, None, :] for k in range(3))
            u_pos = (b0 * v0 + b1 * v1 + b2 * v2).astype(np.float32)
            interp_dir = (b0 * d0 + b1 * d1 + b2 * d2).astype(np.float32)
            present = presence[slot[s:s + _FACE_CHUNK]]     # (n, M)
            scale = height_fn(u_pos).astype(np.float32)
            u_disp = np.where(present[..., None], scale[..., None] * interp_dir,
                              0.0).astype(np.float32)
            for fi, bidx, up, ud, k in zip(sel.tolist(), faces32[sel], u_pos,
                                           u_disp, slot[s:s + _FACE_CHUNK]
                                           .tolist()):
                tris[fi] = mesh_mod.MicroTriangle(
                    base_vertex_indices=bidx, u_positions=up,
                    u_displacements=ud, u_present=shared[k][0],
                    u_faces=shared[k][1])

    out = mesh_mod.MicroMesh(positions=positions, normals=normals,
                             directions=directions, triangles=tris)
    out.validate()
    return out


def make_plane(grid: tuple[int, int] = (4, 4), level: int = 3,
               amplitude: float = 0.25, mixed_levels: bool = False,
               height_fn=None) -> mesh_mod.MicroMesh:
    """Displaced plane in the z=0 plane spanning [-1, 1]^2, normals +z."""
    gx, gy = grid
    xs = np.linspace(-1.0, 1.0, gx + 1)
    ys = np.linspace(-1.0, 1.0, gy + 1)
    vid = lambda i, j: i * (gy + 1) + j
    positions = np.array([[x, y, 0.0] for x in xs for y in ys], np.float32)
    normals = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32),
                      (positions.shape[0], 1))
    faces, levels = [], []
    for i in range(gx):
        for j in range(gy):
            faces.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            faces.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
            if mixed_levels:
                lvl = level if (i + j) % 2 == 0 else max(level - 1, 0)
                levels += [lvl, lvl]
            else:
                levels += [level, level]
    return _build_micromesh(positions, normals, np.asarray(faces),
                            np.asarray(levels), amplitude, height_fn)


def make_icosphere(subdivisions: int = 1, level: int = 3,
                   amplitude: float = 0.15, radius: float = 1.0,
                   mixed_levels: bool = False,
                   height_fn=None) -> mesh_mod.MicroMesh:
    """Displaced icosphere: closed surface, varied triangle orientations."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    for _ in range(subdivisions):
        mid_cache: dict[tuple[int, int], int] = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = tuple(sorted((a, b)))
            if key not in mid_cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                mid_cache[key] = len(verts_list)
                verts_list.append(m)
            return mid_cache[key]

        for f in faces:
            a, b, c = (int(f[0]), int(f[1]), int(f[2]))
            ab, bc_, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc_, ab], [c, ca, bc_],
                          [ab, bc_, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    positions = (verts * radius).astype(np.float32)
    normals = verts.astype(np.float32)
    if mixed_levels:
        levels = np.where(np.arange(len(faces)) % 2 == 0, level,
                          max(level - 1, 0))
        # Mixed assignment may violate the <=1 constraint across arbitrary
        # topology only if level gaps exceed 1, which this scheme cannot.
    else:
        levels = np.full(len(faces), level)
    return _build_micromesh(positions, normals, faces, levels, amplitude,
                            height_fn)
