"""Implicit 4-ary micro-mesh subdivision hierarchy — host-side tables.

The reference walks this hierarchy *per ray* inside a DXR intersection shader
(shaders/intersection.hlsl:277-410): each node subdivides into
four children [near-v0, near-v1, center, near-v2] with buffer slot
`4*parent + digit` and path digits {0: near-v0, 1: near-v1, 2: center,
3: near-v2} (intersection.hlsl:310-338). Flat per-level buffer offset is
(4^l - 1) / 3 (intersection.hlsl:310-313).

On TPU we precompute every ray-independent table once per scene instead:
node corner coordinates, face→node membership, and the stitched leaf
enumeration (the 6 presence cases of intersection.hlsl:342-371). Coordinates
live on the integer micro-vertex grid — v0=(0,0), v1=(n-1,0), v2=(n-1,n-1)
with storage index x*(x+1)/2 + y (intersection.hlsl:105-110,486-488) — so all
subdivision math here is exact integer arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np

# Child slot digits (intersection.hlsl:334-338: pathVals = {0,1,3,2} over the
# emission order [near-v0, near-v1, near-v2, center]).
DIGIT_NEAR_V0 = 0
DIGIT_NEAR_V1 = 1
DIGIT_CENTER = 2
DIGIT_NEAR_V2 = 3


def level_offset(level: int) -> int:
    """First flat index of `level` in the level-ordered node buffer: (4^l-1)/3."""
    return (4**level - 1) // 3


def num_internal_nodes(max_level: int) -> int:
    """Nodes in levels 0..max_level-1 (leaf level excluded, mesh.cpp:119-198)."""
    return level_offset(max_level)


def rows_for_level(level: int) -> int:
    """Micro-vertices per edge: nRows = 2^level + 1."""
    return 2**level + 1


def verts_for_level(level: int) -> int:
    n = rows_for_level(level)
    return n * (n + 1) // 2


def level_from_vertex_count(count: int) -> int:
    """Inverse of verts_for_level (solves n(n+1)/2 = count)."""
    n = int(round((-1 + np.sqrt(1 + 8 * count)) / 2))
    if n * (n + 1) // 2 != count:
        raise ValueError(f"{count} is not a triangular grid vertex count")
    level = int(round(np.log2(n - 1))) if n > 1 else 0
    if rows_for_level(level) != n:
        raise ValueError(f"{count} vertices is not a power-of-two grid")
    return level


def grid_index(coords: np.ndarray) -> np.ndarray:
    """Triangular-grid storage index x*(x+1)/2 + y (intersection.hlsl:105-110)."""
    x = coords[..., 0]
    y = coords[..., 1]
    return x * (x + 1) // 2 + y


def grid_coords(level: int) -> np.ndarray:
    """All (x, y) grid coords for a level, in storage-index order. (M, 2) int."""
    n = rows_for_level(level)
    out = [(x, y) for x in range(n) for y in range(x + 1)]
    return np.asarray(out, dtype=np.int64)


def root_corners(level: int) -> np.ndarray:
    """Corner coords of the base triangle on the level-`level` grid. (3, 2)."""
    s = 2**level
    return np.asarray([[0, 0], [s, 0], [s, s]], dtype=np.int64)


def _edge_midpoints(c: np.ndarray):
    v0, v1, v2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    uv0 = (v0 + v1) // 2
    uv1 = (v1 + v2) // 2
    uv2 = (v2 + v0) // 2
    return v0, v1, v2, uv0, uv1, uv2


def child_corners(c: np.ndarray) -> np.ndarray:
    """Children of node(s) with corners c: (..., 3, 2) -> (..., 4, 3, 2).

    Children in slot/digit order [near-v0, near-v1, center, near-v2]
    (intersection.hlsl:335-338 with pathVals {0,1,3,2}).
    """
    v0, v1, v2, uv0, uv1, uv2 = _edge_midpoints(c)
    near_v0 = np.stack([v0, uv0, uv2], axis=-2)
    near_v1 = np.stack([uv0, v1, uv1], axis=-2)
    center = np.stack([uv0, uv1, uv2], axis=-2)
    near_v2 = np.stack([uv2, uv1, v2], axis=-2)
    return np.stack([near_v0, near_v1, center, near_v2], axis=-3)


@functools.cache
def node_corner_table(level_t: int) -> list[np.ndarray]:
    """Corner grid coords of every node, per level.

    Returns a list over levels 0..level_t; entry l has shape (4^l, 3, 2) in
    finest-grid units (0..2^level_t), indexed by the level-ordered node index
    (child slot = 4*parent + digit).
    """
    tables = [root_corners(level_t)[None]]
    for _ in range(level_t):
        kids = child_corners(tables[-1])          # (K, 4, 3, 2)
        tables.append(kids.reshape(-1, 3, 2))
    return tables


# --- face -> node membership (mesh.cpp:172-180 / 358-366) -------------------

def face_node_paths(face_coords: np.ndarray, level_t: int) -> np.ndarray:
    """Assign each micro-face to its node at every hierarchy level.

    The reference assigns a micro-triangle to one of the four children by the
    barycentric coords of its midpoint w.r.t. the current node's corners:
    bc.x>0.5 -> near-v0, bc.y>0.5 -> near-v1, bc.z>0.5 -> near-v2, else
    center (mesh.cpp:172-180). For grid-affine micro-vertex positions this is
    exact integer arithmetic on grid coords (midpoint components have
    fractional part 1/3 or 2/3, so ties are impossible).

    face_coords: (F, 3, 2) int grid coords (finest level) of face vertices.
    Returns (F, level_t + 1) int64 node index at each level 0..level_t.
    """
    face_coords = np.asarray(face_coords, dtype=np.int64)
    f = face_coords.shape[0]
    # Work in x3 coordinates so face midpoints are integers.
    m = face_coords.sum(axis=1)                       # (F, 2), x3 units
    corners = np.broadcast_to(root_corners(level_t) * 3, (f, 3, 2)).copy()
    node = np.zeros(f, dtype=np.int64)
    paths = [np.zeros(f, dtype=np.int64)]

    def cross2(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    for _ in range(level_t):
        kids = child_corners(corners)                 # (F, 4, 3, 2)
        c0, c1, c2 = corners[:, 0], corners[:, 1], corners[:, 2]
        area = cross2(c1 - c0, c2 - c0)               # > 0 (CCW grid triangle)
        a = cross2(c1 - m, c2 - m)                    # bc.x * area
        b = cross2(m - c0, c2 - c0)                   # bc.y * area
        g = cross2(c1 - c0, m - c0)                   # bc.z * area
        digit = np.where(
            2 * a > area, DIGIT_NEAR_V0,
            np.where(2 * b > area, DIGIT_NEAR_V1,
                     np.where(2 * g > area, DIGIT_NEAR_V2, DIGIT_CENTER)))
        node = 4 * node + digit
        corners = np.take_along_axis(
            kids, digit[:, None, None, None], axis=1)[:, 0]
        paths.append(node.copy())
    return np.stack(paths, axis=1)


# --- stitched leaf enumeration (intersection.hlsl:339-376) ------------------

# Corner selector ids: 0..2 -> node corners v0,v1,v2; 3..5 -> edge midpoints
# uv0 (v0v1), uv1 (v1v2), uv2 (v2v0).
#
# Keyed by the presence pattern (p0, p1, p2) of (uv0, uv1, uv2); each entry is
# the list of emitted leaf triangles, transcribed from the reference's
# re-stitching cases (intersection.hlsl:342-371); the all-present pattern is
# the standard 4-way split in emission order [near-v0, near-v1, near-v2,
# center] (intersection.hlsl:335-337).
STITCH_TABLE: dict[tuple[int, int, int], list[tuple[int, int, int]]] = {
    (1, 1, 1): [(0, 3, 5), (3, 1, 4), (5, 4, 2), (3, 4, 5)],
    (1, 0, 0): [(0, 3, 2), (3, 1, 2)],
    (0, 1, 0): [(0, 1, 4), (0, 4, 2)],
    (0, 0, 1): [(0, 1, 5), (1, 2, 5)],
    (1, 0, 1): [(0, 3, 5), (3, 1, 5), (1, 2, 5)],
    (1, 1, 0): [(0, 3, 2), (3, 1, 4), (3, 4, 2)],
    (0, 1, 1): [(0, 1, 5), (1, 4, 5), (5, 4, 2)],
    # All three midpoints absent: the reference would emit the unmodified
    # first sub-triangle (v0, uv0, uv2) with absent vertices (a latent bug —
    # no remap case exists for this pattern, intersection.hlsl:342-371). We
    # emit the single coarse triangle instead, which matches the tessellated
    # ground-truth geometry.
    (0, 0, 0): [(0, 1, 2)],
}


def enumerate_leaves(level_t: int, present_fn) -> tuple[np.ndarray, np.ndarray]:
    """Enumerate leaf micro-triangles with presence-driven stitching.

    present_fn: maps (K, 2) int finest-grid coords -> (K,) bool presence.
    Returns (slots, corner_coords): slots (NL,) int64 leaf slot in [0, 4^level_t)
    (slot = 4*parent + emission order, so slot >> 2 is the parent node index at
    level level_t - 1), corner_coords (NL, 3, 2) int64 finest-grid coords.
    """
    if level_t == 0:
        return (np.zeros(1, dtype=np.int64),
                root_corners(0)[None].astype(np.int64))

    parents = node_corner_table(level_t)[level_t - 1]  # (P, 3, 2)
    v0, v1, v2, uv0, uv1, uv2 = _edge_midpoints(parents)
    sel = np.stack([v0, v1, v2, uv0, uv1, uv2], axis=1)  # (P, 6, 2)
    present = np.stack(
        [present_fn(uv0), present_fn(uv1), present_fn(uv2)], axis=1)  # (P, 3)

    slots, corners = [], []
    for p_idx in range(parents.shape[0]):
        pat = tuple(int(b) for b in present[p_idx])
        for i, tri in enumerate(STITCH_TABLE[pat]):
            slots.append(4 * p_idx + i)
            corners.append(sel[p_idx][list(tri)])
    return np.asarray(slots, dtype=np.int64), np.stack(corners).astype(np.int64)


def uniform_leaf_corners(level_t: int) -> np.ndarray:
    """All-present leaf corners in slot order. (4^level_t, 3, 2)."""
    slots, corners = enumerate_leaves(
        level_t, lambda c: np.ones(c.shape[:-1], dtype=bool))
    if level_t > 0:
        # all-present emission order is [nv0, nv1, nv2, center] = digits
        # [0, 1, 3, 2]; reorder into digit-slot order for the uniform table.
        order = np.argsort(slots, kind="stable")
        out = np.empty_like(corners)
        digit_of_emission = np.asarray([0, 1, 3, 2])
        parent = slots[order] // 4
        emission = slots[order] % 4
        out[4 * parent + digit_of_emission[emission]] = corners[order]
        return out
    return corners
