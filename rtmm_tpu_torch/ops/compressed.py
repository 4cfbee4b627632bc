"""Compressed traversal units: the host-side grid helpers only.

The DispC1 codec (io/dispc1.py) splits level-4/5 triangles into level-3
subtree blocks, and it needs the subtree grid coordinates below. The
rest of the JAX package's ops/compressed.py (the compressed scene build
and the in-kernel table derivation) belongs to the compressed-scene
slice of the port and is not here yet.
"""
from __future__ import annotations

import functools

import numpy as np

from . import subdivision

SUB_LEVEL = 3       # unit = level-(L-3) subtree -> 64 leaves, 45 vertices


@functools.cache
def local_grid(su: int) -> np.ndarray:
    """(gpts, 2) local grid coords of a level-`su` subtree, storage order."""
    return subdivision.grid_coords(su)


def subtree_grid_coords(level: int) -> tuple[np.ndarray, int]:
    """Global finest-grid coords of every subtree's local grid points.

    Returns (coords (spt, gpts, 2) int64, su): subtree s (the level-(L-su)
    node in hierarchical slot order, su = min(level, SUB_LEVEL)) covers
    local grid point i at global coords coords[s, i]. Exact integer
    arithmetic (subtree corners are multiples of 2^su on the finest grid).
    """
    su = min(level, SUB_LEVEL)
    den = 2 ** su
    sub_corners = subdivision.node_corner_table(level)[level - su]
    local = local_grid(su)                                    # (gpts, 2)
    wa = (den - local[:, 0])[None, :, None]
    wb = (local[:, 0] - local[:, 1])[None, :, None]
    wc = local[:, 1][None, :, None]
    c = sub_corners[:, None]                                  # (spt, 1, 3, 2)
    coords = (c[:, :, 0] * wa + c[:, :, 1] * wb + c[:, :, 2] * wc)
    assert (coords % den == 0).all()
    return coords // den, su
