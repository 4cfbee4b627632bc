"""Base mesh "plane_y0": the square [-1, 1]^2 of the y = 0 plane, a grid of
recipe["grid"] squares a side, two triangles each; normals +y, and each
face wound so that cross(p1 - p0, p2 - p0) points +y (vertex i * (grid +
1) + j at x = xs[i], z = xs[j]; square (i, j) gives faces [a, a + 1,
b + 1] and [a, b + 1, b], a = i * (grid + 1) + j, b = a + grid + 1, in
row-major order of (i, j)).

Recipe keys read: "grid".
"""
from __future__ import annotations

import numpy as np


def arrays(recipe: dict) -> dict:
    """{"positions" (V, 3) float32, "normals" (V, 3) float32, "faces"
    (F, 3) int64}, V = (grid + 1)^2, F = 2 grid^2."""
    n = int(recipe["grid"])
    xs = np.linspace(-1.0, 1.0, n + 1)
    x, z = np.meshgrid(xs, xs, indexing="ij")
    pos = np.stack([x.ravel(), np.zeros(x.size), z.ravel()],
                   axis=1).astype(np.float32)
    i, j = np.meshgrid(np.arange(n, dtype=np.int64),
                       np.arange(n, dtype=np.int64), indexing="ij")
    a = (i * (n + 1) + j).ravel()
    b = a + n + 1
    faces = np.stack([np.stack([a, a + 1, b + 1], axis=1),
                      np.stack([a, b + 1, b], axis=1)], axis=1)
    normals = np.zeros_like(pos)
    normals[:, 1] = 1.0
    return {"positions": pos, "normals": normals,
            "faces": faces.reshape(-1, 3)}
