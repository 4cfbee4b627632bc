"""Compressed traversal units: leaf geometry derived at trace time.

The standard scene tables (unit_qn) materialise every micro-triangle's
Möller-Trumbore rows. A compressed scene stores, per traversal unit (one
level-(L-3) subtree of one base triangle: 64 leaves, 45 shared grid
vertices), only the displaced grid-vertex positions: one (GRID_ROWS,
GRID_LANES) float32 record, ~32 B per micro-triangle. At trace time each
visited unit's 64 leaves are rebuilt from the record: corner gather, edges,
cross products and e2.w2, the reference's on-the-fly reconstruction
(intersection.hlsl:465-470).

Host NumPy part (copied from the JAX package's ops/compressed.py, which
the port does not import): record layout constants, gather matrices and
corner indices, stitched topologies, grid positions and the NumPy oracles
derive_unit_tables_np (recentered primary-ray tables) and derive_q16_np
(absolute secondary-ray tables). Torch part: corner_lanes (a gather
matrix as lane indices); derive_unit_tables, the plain version of the tile
trace kernel's derive (csrc/tile_trace.cu, stage_grid_units); derive_q,
its t_num-folded form for the XLA tile backend; derive_q16, the plain
version of the grouped trace kernel's derive (csrc/group_trace.cu,
stage_grid_unit), also the grouped engine's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import subdivision

GRID_ROWS = 4       # record rows: 0-2 = grid-point xyz, 3 = spare
GRID_LANES = 128    # record width (45 used at sub-level 3)
SUB_LEVEL = 3       # unit = level-(L-3) subtree -> 64 leaves, 45 vertices
LPU = 64            # leaf columns per unit (4^SUB_LEVEL)
# Indexed records (mixed-level / stitched-presence scenes): rows 3-5,
# lanes 0..LPU-1, carry the corner-j lane indices of each leaf, so the
# stitched topology (the reference's 6-case presence re-stitching,
# intersection.hlsl:339-371) is encoded in the unit itself. Index
# GRID_LANES-1 is the degenerate sentinel: lane 127 of every record is zero
# (<= 45 grid points used), so padded leaf columns derive v0 = v1 = v2 = 0
# -> det == 0 -> rejected by the acceptance window.
IDX_ROWS = 6
IDX_SENTINEL = GRID_LANES - 1


@functools.cache
def local_grid(su: int) -> np.ndarray:
    """(gpts, 2) local grid coords of a level-`su` subtree, storage order."""
    return subdivision.grid_coords(su)


@functools.cache
def leaf_gather_matrix(su: int) -> np.ndarray:
    """(GRID_LANES, 3*LPU) one-hot: grid-point lane -> leaf-corner column.

    Column layout [v0 block | v1 block | v2 block] of LPU lanes each; leaf
    k of the unit (emission order, matching the flat leaf table of the
    standard build) reads corner j from column j*LPU + k. Leaves beyond
    4^su and grid lanes beyond the grid size are zero columns/rows.
    """
    corners = subdivision.enumerate_leaves(
        su, lambda c: np.ones(c.shape[:-1], dtype=bool))[1]   # (4^su, 3, 2)
    gidx = subdivision.grid_index(corners)                    # (4^su, 3)
    g = np.zeros((GRID_LANES, 3 * LPU), np.float32)
    for j in range(3):
        g[gidx[:, j], j * LPU + np.arange(corners.shape[0])] = 1.0
    return g


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


def stitched_unit_topology(level: int, present: np.ndarray):
    """Per-subtree leaf-corner lane indices for a stitched triangle class.

    level: the triangle's subdivision level; present: (M,) bool presence
    over its grid vertices (finest-grid storage order). Every stitched
    leaf corner lies AT a grid point, so a unit's topology is 3*LPU lane
    indices into its own record, shared by every triangle of the same
    (level, presence) class.

    Returns (idx (spt, 3, LPU) int32 corner lane indices (IDX_SENTINEL
    pads unused columns), ref (spt, GRID_LANES) bool referenced-lane
    mask, su).
    """
    gcoords, su = subtree_grid_coords(level)          # (spt, gpts, 2)
    spt = gcoords.shape[0]
    lane_of = [{tuple(c): i for i, c in enumerate(map(tuple, gcoords[s]))}
               for s in range(spt)]

    def present_at(c):
        return present[subdivision.grid_index(c)]

    slots, corners = subdivision.enumerate_leaves(level, present_at)
    idx = np.full((spt, 3, LPU), IDX_SENTINEL, np.int32)
    ref = np.zeros((spt, GRID_LANES), bool)
    counts = np.zeros(spt, np.int64)
    shift = 2 * (su - 1)
    for slot, cor in zip(slots, corners):
        s = 0 if level == 0 else int(slot) // 4 >> shift
        k = counts[s]
        counts[s] += 1
        for j in range(3):
            ln = lane_of[s][tuple(cor[j])]
            idx[s, j, k] = ln
            ref[s, ln] = True
    assert counts.max(initial=0) <= LPU
    return idx, ref, su


def uniform_unit_indices(su: int) -> np.ndarray:
    """(3, LPU) corner lane indices of the all-present topology — the
    index form of leaf_gather_matrix(su) (same emission order); columns
    beyond 4^su get the degenerate sentinel."""
    g = leaf_gather_matrix(su)                        # (GRID_LANES, 3*LPU)
    idx = np.full((3, LPU), IDX_SENTINEL, np.int32)
    for j in range(3):
        blk = g[:, j * LPU:(j + 1) * LPU]
        lanes, cols = np.nonzero(blk)
        idx[j, cols] = lanes
    return idx


def gather_matrix_from_indices(idx3: np.ndarray) -> np.ndarray:
    """(3, LPU) corner lane indices -> (GRID_LANES, 3*LPU) one-hot gather
    matrix (leaf_gather_matrix's layout). Sentinel indices become one-hots
    onto the guaranteed-zero lane GRID_LANES-1. An indexed scene whose
    units all share one topology stores this matrix as unit_gmat."""
    g = np.zeros((GRID_LANES, 3 * LPU), np.float32)
    for j in range(3):
        g[np.asarray(idx3[j], np.int64), j * LPU + np.arange(LPU)] = 1.0
    return g


def pack_index_rows(idx: np.ndarray) -> np.ndarray:
    """(..., 3, LPU) int corner indices -> (..., 3, GRID_LANES) f32 record
    rows (row j lanes 0..LPU-1 = corner-j indices; layout above)."""
    lead = idx.shape[:-2]
    rows = np.full(lead + (3, GRID_LANES), float(IDX_SENTINEL), np.float32)
    rows[..., :, 0 * LPU:1 * LPU] = idx
    return rows


def grid_positions(v0, v1, v2, d0, d1, d2, scales, gcoords, level):
    """Displaced positions of every (triangle, subtree, grid point).

    v0..d2: (N, 3) base corner positions/directions; scales: (N, M)
    displacement scales; gcoords: (spt, gpts, 2) from subtree_grid_coords.
    Returns (N, spt, gpts, 3) float32 — element for element the closed form
    of ops/precompute.build_uniform_tables' leaf vertices (same arithmetic
    at the same grid points, so bitwise identical to the standard tables).
    """
    denom = max(2 ** level, 1)
    u = gcoords[..., 0] / denom                               # (spt, gpts)
    w = gcoords[..., 1] / denom
    lbc = np.stack([1.0 - u, u - w, w], axis=-1).astype(np.float32)
    base = (lbc[None, ..., 0:1] * v0[:, None, None]
            + lbc[None, ..., 1:2] * v1[:, None, None]
            + lbc[None, ..., 2:3] * v2[:, None, None])
    dirs = (lbc[None, ..., 0:1] * d0[:, None, None]
            + lbc[None, ..., 1:2] * d1[:, None, None]
            + lbc[None, ..., 2:3] * d2[:, None, None])
    gidx = subdivision.grid_index(gcoords)                    # (spt, gpts)
    s = scales[:, gidx]                                       # (N, spt, gpts)
    return (base + s[..., None] * dirs).astype(np.float32)


def _corner_indices_np(grid: np.ndarray) -> np.ndarray:
    """(U, IDX_ROWS, GRID_LANES) indexed record -> (U, 3, LPU) int64."""
    return grid[:, 3:6, 0 * LPU:1 * LPU].astype(np.int64)


def derive_unit_tables_np(grid: np.ndarray, apex: np.ndarray, su: int,
                          centers: np.ndarray | None = None,
                          indexed: bool = False):
    """NumPy oracle of the trace-time derivation.

    grid: (U, GRID_ROWS, GRID_LANES) unit records; apex: (3,); centers:
    (U, 3) unit AABB centers (the recentering origin; None = absolute
    frame). Returns dict(q (U, 8, 4*LPU) with the per-frame t_num in row 7
    of the t block, nrm (U, LPU, 3)).
    """
    if centers is None:
        centers = np.zeros((grid.shape[0], 3), grid.dtype)
    pos = grid[:, 0:3, :]                                     # (U, 3, GL)
    if indexed:
        idx = _corner_indices_np(grid)                        # (U, 3, LPU)
        take = lambda j: np.take_along_axis(                  # noqa: E731
            pos, idx[:, j][:, None, :], axis=2).transpose(0, 2, 1)
        v0, v1, v2 = take(0), take(1), take(2)                # (U, LPU, 3)
    else:
        g = leaf_gather_matrix(su)
        v = pos @ g                                           # (U, 3, 3*LPU)
        v0 = v[:, :, 0 * LPU:1 * LPU].transpose(0, 2, 1)      # (U, LPU, 3)
        v1 = v[:, :, 1 * LPU:2 * LPU].transpose(0, 2, 1)
        v2 = v[:, :, 2 * LPU:3 * LPU].transpose(0, 2, 1)
    e1 = v1 - v0
    e2 = v2 - v0
    v0c = v0 - centers[:, None, :]
    n = np.cross(e1, e2)
    w1 = np.cross(e2, v0c)
    w2 = np.cross(v0c, e1)
    e2w2 = (e2 * w2).sum(-1)
    t_num = (n * (apex - centers)[:, None, :]).sum(-1) - e2w2  # (U, LPU)
    q = np.zeros((grid.shape[0], 8, 4 * LPU), np.float32)
    q[:, 0:3, 0 * LPU:1 * LPU] = -n.transpose(0, 2, 1)
    q[:, 0:3, 1 * LPU:2 * LPU] = -w1.transpose(0, 2, 1)
    q[:, 3:6, 1 * LPU:2 * LPU] = e2.transpose(0, 2, 1)
    q[:, 0:3, 2 * LPU:3 * LPU] = -w2.transpose(0, 2, 1)
    q[:, 3:6, 2 * LPU:3 * LPU] = -e1.transpose(0, 2, 1)
    q[:, 7, 3 * LPU:4 * LPU] = t_num
    norm = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return dict(q=q, nrm=(n / norm).astype(np.float32))


# ----------------------------------------------------------------------
# Torch: the plain version of the kernel's derive.

def corner_lanes(gmat: torch.Tensor) -> torch.Tensor:
    """(GRID_LANES, 3*LPU) one-hot gather matrix -> (3, LPU) int32 lane
    indices. The JAX kernel gathers corners with a one-hot matmul that is
    bit-exact by construction, so an indexed load of the same lane is the
    same value. Zero columns point at the guaranteed-zero lane
    GRID_LANES-1: they derive zero rows, which det == 0 rejects."""
    lanes = torch.where(gmat.amax(dim=0) > 0, gmat.argmax(dim=0),
                        IDX_SENTINEL)
    return lanes.reshape(3, LPU).to(torch.int32).contiguous()


def _cross(a, b):
    """Row cross product of 3-lists of tensors, _derive_unit's term order."""
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def derive_unit_tables(records: torch.Tensor, apex: torch.Tensor,
                       centers: torch.Tensor,
                       corners: torch.Tensor | None = None):
    """Derive the Möller-Trumbore tables of n units from their records.

    records (n, GRID_ROWS | IDX_ROWS, GRID_LANES) f32; apex (3,) f32;
    centers (n, 3) f32 unit AABB centers (the recentering origin);
    corners (3, LPU) int lane indices shared by every unit, or None to
    read each unit's own index rows 3-5 (indexed records).

    Returns (q (n, 6, 3*LPU) recentered [-n|-w1|-w2] over [0|e2|-e1], the
    det|u|v column blocks of unit_qn; t_num (n, LPU) = (apex-c).n - e2.w2;
    nrm (n, LPU, 3) normalised normals). The float32 operations and their
    order are those of pallas_tiled._derive_unit, which the trace kernel
    repeats (csrc/tile_trace.cu, stage_grid_units).
    """
    v0, v1, v2 = _corners(records, corners)
    c = [centers[:, r:r + 1] for r in range(3)]               # (n, 1)
    a = [apex[r] for r in range(3)]
    e1 = [v1[r] - v0[r] for r in range(3)]
    e2 = [v2[r] - v0[r] for r in range(3)]
    v0c = [v0[r] - c[r] for r in range(3)]
    nv = _cross(e1, e2)
    w1 = _cross(e2, v0c)
    w2 = _cross(v0c, e1)
    e2w2 = e2[0] * w2[0] + e2[1] * w2[1] + e2[2] * w2[2]
    t_num = ((a[0] - c[0]) * nv[0] + (a[1] - c[1]) * nv[1]
             + (a[2] - c[2]) * nv[2] - e2w2)
    zero = torch.zeros_like(e1[0])
    q = torch.stack([
        torch.cat([-nv[r], -w1[r], -w2[r]], dim=1) for r in range(3)
    ] + [
        torch.cat([zero, e2[r], -e1[r]], dim=1) for r in range(3)
    ], dim=1)                                                 # (n, 6, 3*LPU)
    nn = torch.clamp_min(
        torch.sqrt(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]), 1e-20)
    nrm = torch.stack([torch.div(nv[r], nn) for r in range(3)], dim=-1)
    return q, t_num, nrm


def derive_q16_np(grid: np.ndarray, su: int, indexed: bool = False):
    """NumPy oracle of the arbitrary-origin (secondary-bounce) MT table.

    Derives the scene's unit_q16 layout — ray rows [d(3), o x d(3), o(3),
    1, pad(6)], absolute coordinates — from grid records (the same closed
    form, so values match the precomputed table up to fp reassociation).
    Returns dict(q16 (U, 16, 4*LPU), nrm (U, LPU, 3))."""
    pos = grid[:, 0:3, :]
    if indexed:
        idx = _corner_indices_np(grid)
        take = lambda j: np.take_along_axis(                  # noqa: E731
            pos, idx[:, j][:, None, :], axis=2).transpose(0, 2, 1)
        v0, v1, v2 = take(0), take(1), take(2)                # (U, LPU, 3)
    else:
        g = leaf_gather_matrix(su)
        v = pos @ g
        v0 = v[:, :, 0 * LPU:1 * LPU].transpose(0, 2, 1)
        v1 = v[:, :, 1 * LPU:2 * LPU].transpose(0, 2, 1)
        v2 = v[:, :, 2 * LPU:3 * LPU].transpose(0, 2, 1)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    w1a = np.cross(e2, v0)
    w2a = np.cross(v0, e1)
    e2w2a = (e2 * w2a).sum(-1).astype(np.float32)
    u = grid.shape[0]
    q16 = np.zeros((u, 16, 4 * LPU), np.float32)
    q16[:, 0:3, 0 * LPU:1 * LPU] = -n.transpose(0, 2, 1)
    q16[:, 0:3, 1 * LPU:2 * LPU] = -w1a.transpose(0, 2, 1)
    q16[:, 3:6, 1 * LPU:2 * LPU] = e2.transpose(0, 2, 1)
    q16[:, 0:3, 2 * LPU:3 * LPU] = -w2a.transpose(0, 2, 1)
    q16[:, 3:6, 2 * LPU:3 * LPU] = -e1.transpose(0, 2, 1)
    q16[:, 6:9, 3 * LPU:4 * LPU] = n.transpose(0, 2, 1)
    q16[:, 9, 3 * LPU:4 * LPU] = -e2w2a
    norm = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return dict(q16=q16, nrm=(n / norm).astype(np.float32))


def _corners(records: torch.Tensor, corners: torch.Tensor | None):
    """The three corner positions of every leaf: 3 lists of 3 (n, LPU)
    component tensors, gathered by the shared corner lanes or (corners
    None) each record's own index rows 3-5."""
    n_units = records.shape[0]
    pos = records[:, 0:3, :]                                  # (n, 3, GL)
    if corners is None:
        idx = records[:, 3:6, 0:LPU].to(torch.int64)          # (n, 3, LPU)
    else:
        idx = corners.to(device=records.device,
                         dtype=torch.int64).expand(n_units, 3, LPU)

    def corner(j):
        lanes = idx[:, j:j + 1, :].expand(n_units, 3, LPU)
        v = torch.gather(pos, 2, lanes)
        return [v[:, 0], v[:, 1], v[:, 2]]

    return corner(0), corner(1), corner(2)


def derive_q16(records: torch.Tensor, corners: torch.Tensor | None = None):
    """Derive the arbitrary-origin MT tables of n units from their records
    (the torch counterpart of the JAX package's derive_q16_jnp, and the
    plain version of the grouped trace kernel's derive, csrc/group_trace.cu
    stage_grid_unit).

    records (n, GRID_ROWS | IDX_ROWS, GRID_LANES) f32; corners (3, LPU)
    shared corner lanes, or None to read each record's index rows 3-5.
    Returns (q16 (n, 16, 4*LPU): rows [-n|-w1|-w2|0] over the d rows,
    [0|e2|-e1|0] over the moment rows, [0|0|0|n] over the origin rows and
    [0|0|0|-e2.w2] over the ones row, w1 = e2 x v0, w2 = v0 x e1; nrm (n,
    LPU, 3) normalised normals). Sums run left to right, as the kernel's.
    """
    v0, v1, v2 = _corners(records, corners)
    e1 = [v1[r] - v0[r] for r in range(3)]
    e2 = [v2[r] - v0[r] for r in range(3)]
    nv = _cross(e1, e2)
    w1 = _cross(e2, v0)
    w2 = _cross(v0, e1)
    e2w2 = e2[0] * w2[0] + e2[1] * w2[1] + e2[2] * w2[2]
    zero = torch.zeros_like(e1[0])
    rows = ([torch.cat([-nv[r], -w1[r], -w2[r], zero], dim=1)
             for r in range(3)]
            + [torch.cat([zero, e2[r], -e1[r], zero], dim=1)
               for r in range(3)]
            + [torch.cat([zero, zero, zero, nv[r]], dim=1) for r in range(3)]
            + [torch.cat([zero, zero, zero, -e2w2], dim=1)])
    pad = torch.zeros_like(rows[0])
    q16 = torch.stack(rows + [pad] * 6, dim=1)                # (n, 16, 4L)
    nn = torch.clamp_min(
        torch.sqrt(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]), 1e-20)
    nrm = torch.stack([torch.div(nv[r], nn) for r in range(3)], dim=-1)
    return q16, nrm


def derive_q(records: torch.Tensor, apex: torch.Tensor,
             centers: torch.Tensor, corners: torch.Tensor | None = None):
    """Derive the recentered primary-ray MT tables of n units for the
    tile backend (the counterpart of the JAX package's derive_q_jnp).

    Returns (q (n, 8, 4*LPU) — the det|u|v|t blocks of unit_qn, with the
    per-frame t_num = (apex-c).n - e2.w2 in row 7 of the t block; nrm (n,
    LPU, 3))."""
    q6, t_num, nrm = derive_unit_tables(records, apex, centers, corners)
    n_units = records.shape[0]
    q = torch.zeros((n_units, 8, 4 * LPU), dtype=torch.float32,
                    device=records.device)
    q[:, 0:6, 0:3 * LPU] = q6
    q[:, 7, 3 * LPU:4 * LPU] = t_num
    return q, nrm
