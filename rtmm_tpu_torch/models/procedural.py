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


def _build_micromesh(positions: np.ndarray, normals: np.ndarray,
                     faces: np.ndarray, levels: np.ndarray,
                     amplitude: float, height_fn=None) -> mesh_mod.MicroMesh:
    """Assemble a MicroMesh from a base mesh + per-face subdivision levels."""
    positions = positions.astype(np.float32)
    normals = normals.astype(np.float32)
    directions = normals.copy()          # displace along vertex normals
    height_fn = height_fn or (lambda p: _default_height(p, amplitude))

    # Per-edge neighbor levels for presence computation.
    edge_levels: dict[tuple[int, int], list[int]] = {}
    for f, lvl in zip(faces, levels):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((int(f[a]), int(f[b]))))
            edge_levels.setdefault(key, []).append(int(lvl))

    tris: list[mesh_mod.MicroTriangle] = []
    for f, lvl in zip(faces, levels):
        lvl = int(lvl)
        n = subdivision.rows_for_level(lvl)
        coords = subdivision.grid_coords(lvl)               # (M, 2)
        denom = max(n - 1, 1)
        u = coords[:, 0] / denom
        w = coords[:, 1] / denom
        bc = np.stack([1.0 - u, u - w, w], axis=1)          # (M, 3)

        v0, v1, v2 = positions[f[0]], positions[f[1]], positions[f[2]]
        d0, d1, d2 = directions[f[0]], directions[f[1]], directions[f[2]]
        u_pos = (bc[:, :1] * v0 + bc[:, 1:2] * v1 + bc[:, 2:3] * v2).astype(
            np.float32)
        interp_dir = (bc[:, :1] * d0 + bc[:, 1:2] * d1
                      + bc[:, 2:3] * d2).astype(np.float32)

        # Presence: finest-level (odd) vertices on an edge shared with a
        # lower-level neighbor are absent (mesh.h:16, TinyGLTFLoader.cpp:59-79).
        present = np.ones(coords.shape[0], dtype=bool)
        if n > 2:
            edge_specs = [  # (edge key, mask of verts on that edge, position along)
                ((int(f[0]), int(f[1])), coords[:, 1] == 0, coords[:, 0]),
                ((int(f[1]), int(f[2])), coords[:, 0] == denom, coords[:, 1]),
                ((int(f[2]), int(f[0])), coords[:, 0] == coords[:, 1],
                 coords[:, 0]),
            ]
            for key, on_edge, along in edge_specs:
                neigh = [l for l in edge_levels[tuple(sorted(key))]]
                if len(neigh) == 2 and min(neigh) == lvl - 1:
                    present &= ~(on_edge & (along % 2 == 1))

        scale = height_fn(u_pos).astype(np.float32)
        u_disp = np.where(present[:, None], scale[:, None] * interp_dir,
                          0.0).astype(np.float32)

        # Leaf enumeration with stitching == the tessellation uFaces, so the
        # tessellated ground truth and the traversal see identical geometry.
        fine = 2 ** lvl
        step = denom // fine if fine else 1

        def present_at(c, _present=present, _step=step):
            return _present[subdivision.grid_index(c * _step)]

        _, corners = subdivision.enumerate_leaves(lvl, present_at)
        u_faces = subdivision.grid_index(corners * step).astype(np.int32)

        tris.append(mesh_mod.MicroTriangle(
            base_vertex_indices=np.asarray(f, dtype=np.int32),
            u_positions=u_pos,
            u_displacements=u_disp,
            u_present=present,
            u_faces=u_faces,
        ))

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
