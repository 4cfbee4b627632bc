"""The benchmark's scenes as plain arrays: the height field and the
tessellation of a uniform-level micro-mesh over a base mesh (the base
meshes are rtbench/bases/<name>.py).

A frozen copy of the rules the renderer's assets follow (the reference
renderer's micro-mesh model, framework/include/framework/mesh.h, and its
`-T` tessellated ground truth, mesh.cpp:54-95): per base triangle a
triangular grid of (2^level + 1)(2^level + 2)/2 micro-vertices at grid
coordinates (x, y), 0 <= y <= x <= 2^level, with barycentrics
(1 - u, u - w, w), u = x / 2^level, w = y / 2^level; each displaced along
the barycentric blend of the base vertex directions by the height field.
Every micro-triangle keeps the winding of its base triangle, so its
geometric normal cross(p1 - p0, p2 - p0) points the way the base
triangle's does.
"""
from __future__ import annotations

import numpy as np


class HeightField:
    """The smooth height field of the renderer's procedural assets, a
    phase per term (zeros: the field as published); the amplitude is the
    scene's. Maps (..., 3) float32 points to (...) float32 heights,
    computed in float64."""

    def __init__(self, amplitude: float, phase: tuple[float, float, float,
                                                       float]):
        self.amplitude = float(amplitude)
        self.phase = tuple(float(p) for p in phase)

    def __call__(self, p: np.ndarray) -> np.ndarray:
        x, y, z = (np.asarray(p[..., k], np.float64) for k in range(3))
        a, b, c, d = self.phase
        h = self.amplitude * (
            0.55 * np.sin(3.1 * x + 1.3 + a) * np.cos(2.7 * y - 0.4 + b)
            + 0.3 * np.sin(6.3 * y + 2.0 * z + c)
            + 0.15 * np.cos(9.1 * (x + y + 0.5 * z) + d))
        return h.astype(np.float32)


def grid(level: int) -> tuple[np.ndarray, np.ndarray]:
    """(coords (M, 2) int64 in storage order x (x + 1) / 2 + y,
    micro-faces (4^level, 3) int64 into them, base winding)."""
    n = 2 ** level
    coords = np.asarray([(x, y) for x in range(n + 1) for y in range(x + 1)],
                        dtype=np.int64)

    def idx(x, y):
        return x * (x + 1) // 2 + y

    faces = []
    for x in range(n):
        for y in range(x + 1):
            faces.append((idx(x, y), idx(x + 1, y), idx(x + 1, y + 1)))
            if y < x:
                faces.append((idx(x, y), idx(x + 1, y + 1), idx(x, y + 1)))
    return coords, np.asarray(faces, dtype=np.int64)


def tessellate(positions: np.ndarray, directions: np.ndarray,
               faces: np.ndarray, level: int, height) -> tuple[np.ndarray,
                                                              np.ndarray]:
    """The displaced micro-triangles of a uniform-level micro-mesh:
    (vertices (F, M, 3) float32, triangles (F * 4^level, 3) int64 into
    the flattened vertices). The undisplaced point and the direction are
    barycentric blends in float64 cast to float32; the displaced point is
    point + height(point) * direction in float32."""
    positions = np.asarray(positions, np.float32)
    directions = np.asarray(directions, np.float32)
    coords, micro = grid(level)
    n = 2 ** level
    u = coords[:, 0] / n
    w = coords[:, 1] / n
    b0, b1, b2 = ((1.0 - u)[None, :, None], (u - w)[None, :, None],
                  w[None, :, None])
    v0, v1, v2 = (positions[faces[:, k]][:, None, :] for k in range(3))
    d0, d1, d2 = (directions[faces[:, k]][:, None, :] for k in range(3))
    point = (b0 * v0 + b1 * v1 + b2 * v2).astype(np.float32)
    direction = (b0 * d0 + b1 * d1 + b2 * d2).astype(np.float32)
    h = np.asarray(height(point), np.float32)
    verts = (point + h[..., None] * direction).astype(np.float32)
    m = coords.shape[0]
    tris = (micro[None, :, :] + (np.arange(faces.shape[0]) * m)[:, None, None])
    return verts, tris.reshape(-1, 3)


def scene_arrays(recipe: dict, base: dict) -> dict:
    """The scene of a configuration: its height field and the tessellation
    of the base mesh `base` ({"positions", "normals", "faces"}, displaced
    along the normals) at the recipe's "level", "amplitude" and "phase"."""
    height = HeightField(recipe["amplitude"], recipe["phase"])
    micro_v, micro_t = tessellate(base["positions"], base["normals"],
                                  base["faces"], int(recipe["level"]),
                                  height)
    return {"height": height, "vertices": micro_v.reshape(-1, 3),
            "triangles": micro_t}
