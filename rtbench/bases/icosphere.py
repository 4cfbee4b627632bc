"""Base mesh "icosphere": the unit icosphere, each face split in four
`subdivisions` times with midpoints pushed onto the sphere; each vertex
displaces along its normal (the point itself).

Recipe keys read: "subdivisions".
"""
from __future__ import annotations

import numpy as np


def arrays(recipe: dict) -> dict:
    """{"positions" (V, 3) float32, "normals" (V, 3) float32, "faces"
    (F, 3) int64}."""
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
    for _ in range(int(recipe["subdivisions"])):
        vlist = list(verts)
        mids: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = vlist[a] + vlist[b]
                mids[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return mids[key]

        new = []
        for a, b, c in faces.tolist():
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new, dtype=np.int64)
    return {"positions": verts.astype(np.float32),
            "normals": verts.astype(np.float32), "faces": faces}
