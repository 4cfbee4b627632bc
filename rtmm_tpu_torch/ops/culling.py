"""Tile-frustum candidate culling — the frame prologue's acceleration stage.

The reference leans on hardware TLAS traversal per ray
(src/application.cpp:214). Here candidates are found per *ray tile*: the
frame is split into 32x32-pixel tiles whose primary rays share an origin
and form a 4-plane frustum cone.

Two-level structure (the TLAS role, src/GPUMesh.cpp:238-278): traversal
units are Morton-ordered at scene build and grouped into *clusters* of
UNITS_PER_CLUSTER consecutive units with a cluster AABB. Per frame, every
cluster is tested against every tile frustum; the trace kernel then culls
each visited cluster's units against the tile's sub-cones itself.

Conservative everywhere: a box is culled only if its AABB lies fully
outside one frustum plane (p-vertex test). The mirror cone behind the
camera is automatically rejected because all plane dots flip sign.
"""
from __future__ import annotations

import functools

import torch

from . import _f32

# Pixel footprint of one ray tile: one CUDA block of 1,024 threads, one ray
# each, in the trace kernel. Fixed in the port (the JAX package reads an
# RTMM_TILE_SHAPE override for TPU experiments).
TILE_H = 32
TILE_W = 32
# Traversal units per scene cluster (the coarse level of the two-level cull).
UNITS_PER_CLUSTER = 64


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, component formula of jnp.cross."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def tile_frustums(inv_view_proj, width: int, height: int,
                  render_width: int | None = None,
                  render_height: int | None = None, device="cuda"):
    """Build per-tile frustum planes from the corner pixel rays.

    render_width/height (multiples of TILE_W/TILE_H) define the padded tile
    grid; width/height define the NDC mapping (as in raygen.generate_rays).
    Returns (apex (3,), normals (tiles, 4, 3)): points p inside a tile's
    cone satisfy dot(n_i, p - apex) >= 0 for all 4 planes. Leading axes on
    inv_view_proj (F, 4, 4) batch frames: apex (F, 3), normals (F, tiles,
    4, 3), each frame's values those of its own call.
    """
    m = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=device)
    rw = render_width or width
    rh = render_height or height
    tx = rw // TILE_W
    ty = rh // TILE_H

    def unproject(px, py, z):
        u = _f32.div(_f32.const(px, m), float(width))
        v = _f32.div(_f32.const(py, m), float(height))
        ndc_x = u * 2.0 - 1.0
        ndc_y = -(v * 2.0 - 1.0)
        p = [m[..., i, 0] * ndc_x + m[..., i, 1] * ndc_y
             + (m[..., i, 2] * z + m[..., i, 3]) for i in range(4)]
        return torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1)

    # All primary rays pass through the camera position (the cone apex).
    # Unprojecting it directly is ill-posed (w -> 0), so recover it as the
    # closest-approach point of two corner pixel rays.
    n00 = unproject(0.0, 0.0, 0.0)
    f00 = unproject(0.0, 0.0, 1.0)
    n11 = unproject(float(rw), float(rh), 0.0)
    f11 = unproject(float(rw), float(rh), 1.0)
    apex = _ray_closest_point(n00, f00 - n00, n11, f11 - n11)

    normals = _cone_grid_normals(m, width, height, rw, rh, 1, 1)
    return apex, normals.reshape(*m.shape[:-2], ty * tx, 4, 3)


@functools.lru_cache(maxsize=16)
def _corner_ndc(width: int, height: int, rw: int, rh: int, n_rows: int,
                n_cols: int, device: torch.device):
    """(ndc_x, ndc_y), each (ty, tx, n_rows+1, n_cols+1): the NDC
    coordinates of every tile's sub-cone corner pixels. They depend on the
    frame's size and the grid only, so they are built once per shape and
    device (the cache holds a few small tensors; callers only read them).
    """
    tx = rw // TILE_W
    ty = rh // TILE_H
    sw = TILE_W // n_cols
    sh = TILE_H // n_rows
    f32 = torch.float32

    cx = (torch.arange(tx, dtype=f32, device=device) * TILE_W)[None, :].expand(
        ty, tx)
    cy = (torch.arange(ty, dtype=f32, device=device) * TILE_H)[:, None].expand(
        ty, tx)
    # Corner pixel grid: (ty, tx, n_rows+1, n_cols+1)
    gx = torch.arange(n_cols + 1, dtype=f32, device=device) * sw
    gy = torch.arange(n_rows + 1, dtype=f32, device=device) * sh
    px = cx[..., None, None] + gx[None, None, None, :]
    py = cy[..., None, None] + gy[None, None, :, None]

    u = _f32.div(px, float(width))
    v = _f32.div(py, float(height))
    return u * 2.0 - 1.0, -(v * 2.0 - 1.0)


def _cone_grid_normals(m: torch.Tensor, width: int, height: int,
                       rw: int, rh: int, n_rows: int, n_cols: int):
    """Inward-oriented plane normals for an n_rows x n_cols grid of
    sub-cones per tile: one batched unproject over all (tile, corner)
    pairs and one cross product.

    m is (4, 4), or (F, 4, 4) for F frames in one pass (m[..., i, j]
    broadcast over the corner grid). Returns (..., tiles, n_rows*n_cols,
    4, 3).
    """
    tx = rw // TILE_W
    ty = rh // TILE_H
    ndc_x, ndc_y = _corner_ndc(width, height, rw, rh, n_rows, n_cols,
                               m.device)
    lead = m.shape[:-2]
    mg = m[..., None, None, None, None, :, :]     # (..., 1, 1, 1, 1, 4, 4)

    def unproj(z):
        p = [mg[..., i, 0] * ndc_x + mg[..., i, 1] * ndc_y
             + (mg[..., i, 2] * z + mg[..., i, 3]) for i in range(4)]
        return torch.stack([p[0] / p[3], p[1] / p[3], p[2] / p[3]], dim=-1)

    d = unproj(1.0) - unproj(0.0)
    d = d / _norm(d, keepdim=True)

    # Per cone: corners TL/TR/BR/BL; edges (TL,TR),(TR,BR),(BR,BL),(BL,TL).
    tl = d[..., :-1, :-1, :]
    tr = d[..., :-1, 1:, :]
    br = d[..., 1:, 1:, :]
    bl = d[..., 1:, :-1, :]
    a = torch.stack([tl, tr, br, bl], dim=-2)       # (...,ty,tx,nr,nc,4,3)
    b = torch.stack([tr, br, bl, tl], dim=-2)
    n = _cross(a, b)
    # Orient inward. The corner-sum direction lies strictly inside the
    # (convex) cone, so its dot sign equals the center direction's.
    dc = (tl + tr + br + bl)[..., None, :]
    sign = torch.sign((n * dc).sum(-1, keepdim=True))
    sign = torch.where(sign == 0.0, 1.0, sign)
    n = n * sign
    # (..., ty, tx, nr, nc, 4, 3) -> (..., tiles, nr*nc, 4, 3),
    # j = row*nc + col.
    return n.reshape(*lead, ty * tx, n_rows * n_cols, 4, 3)


# Default sub-cones per tile (vertical 8-px strips of the 32-px tile).
SUB_FRUSTA = 4


def tile_sub_frustums(inv_view_proj, width: int, height: int,
                      render_width: int | None = None,
                      render_height: int | None = None,
                      n_sub: int = SUB_FRUSTA,
                      n_rows: int = 1, device="cuda") -> torch.Tensor:
    """Per-tile SUB-frustum planes: each tile split into an
    n_rows x (n_sub // n_rows) grid of cones (n_rows=1: vertical strips).

    Narrow cones let the trace kernel prune per sub-tile: a unit is a
    candidate only for sub-tiles whose cone reaches it AND whose own worst
    hit it could still beat.

    Returns normals (tiles, n_sub, 4, 3), sub index j = row * cols + col,
    with the same orientation convention as tile_frustums; (F, tiles,
    n_sub, 4, 3) for inv_view_proj (F, 4, 4).
    """
    if n_sub % n_rows or TILE_H % n_rows:
        raise ValueError(f"n_rows={n_rows} must divide n_sub={n_sub} and "
                         f"the {TILE_H}-px tile height")
    n_cols = n_sub // n_rows
    if TILE_W % n_cols:
        raise ValueError(f"{n_cols} columns must divide the {TILE_W}-px "
                         "tile")
    m = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=device)
    rw = render_width or width
    rh = render_height or height
    return _cone_grid_normals(m, width, height, rw, rh, n_rows, n_cols)


def _ray_closest_point(o1, d1, o2, d2):
    """Closest point of two rays (the shared camera apex for primaries)."""
    a = (d1 * d1).sum(-1)
    b = (d1 * d2).sum(-1)
    c = (d2 * d2).sum(-1)
    w = o1 - o2
    d = (d1 * w).sum(-1)
    e = (d2 * w).sum(-1)
    den = a * c - b * b
    den = torch.where(torch.abs(den) < 1e-12, _f32.const(1e-12, den), den)
    s = (b * e - c * d) / den
    t = (a * e - b * d) / den
    return 0.5 * ((o1 + s[..., None] * d1) + (o2 + t[..., None] * d2))


def cull_units(apex: torch.Tensor, normals: torch.Tensor,
               aabb_min: torch.Tensor, aabb_max: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(tiles, U) bool: unit AABB intersects tile frustum (conservative).
    Leading batch axes on apex (..., 3) and normals (..., tiles, 4, 3) (one
    object-space camera per instance) give (..., tiles, U)."""
    # p-vertex per plane: the AABB corner furthest along the plane normal.
    n = normals[..., None, :]                      # (tiles, 4, 1, 3)
    a = apex[..., None, :]
    pmin = (aabb_min - a)[..., None, None, :, :]   # (1, 1, U, 3)
    pmax = (aabb_max - a)[..., None, None, :, :]
    pvert = torch.where(n >= 0.0, pmax, pmin)
    outside = (n * pvert).sum(-1) < 0.0            # (tiles, 4, U)
    return (~outside.any(dim=-2)) & valid


def aabb_distance(apex: torch.Tensor, aabb_min: torch.Tensor,
                  aabb_max: torch.Tensor) -> torch.Tensor:
    """Conservative apex -> AABB distance lower bound.

    apex (3,); aabb_min/max (..., 3) -> (...,). Zero inside the box.
    Plain broadcasting: an apex per frame (F, 1, 3) against boxes (C, 3)
    gives (F, C).
    """
    return _norm(torch.clamp_min(
        torch.maximum(aabb_min - apex, apex - aabb_max), 0.0))


def frustum_hit_gathered(normals: torch.Tensor, apex: torch.Tensor,
                         aabb_min: torch.Tensor,
                         aabb_max: torch.Tensor) -> torch.Tensor:
    """Per-tile p-vertex test on per-tile gathered AABBs.

    normals (tiles, 4, 3); aabb_min/max (tiles, N, 3) -> (tiles, N) bool.
    The refine stage of the XLA tile backend's two-level cull: each tile
    tests only the boxes gathered from its own candidate clusters.
    """
    n = normals[:, :, None, :]                     # (tiles, 4, 1, 3)
    pmin = (aabb_min - apex)[:, None]              # (tiles, 1, N, 3)
    pmax = (aabb_max - apex)[:, None]
    pvert = torch.where(n >= 0.0, pmax, pmin)
    outside = (n * pvert).sum(-1) < 0.0            # (tiles, 4, N)
    return ~outside.any(dim=1)


def candidate_lists(hit: torch.Tensor, max_candidates: int,
                    apex: torch.Tensor | None = None,
                    aabb_min: torch.Tensor | None = None,
                    aabb_max: torch.Tensor | None = None):
    """Compact per-tile candidate lists, front-to-back.

    hit: (tiles, U) bool. Returns (idx (tiles, C) int32, count (tiles,)
    int32, entry (tiles, C) f32): the first C unit indices with hit=True
    per tile and the true per-tile hit count (count > C is overflow).
    With apex and AABBs the candidates are ordered by the apex->AABB
    distance bound, which `entry` carries (+inf past the hits); without,
    by unit index, with entry 0. Ties keep the lower index, as
    jax.lax.top_k does (a stable sort; never torch.topk).
    """
    u = hit.shape[1]
    c = min(max_candidates, u)
    if apex is not None:
        dist = aabb_distance(apex, aabb_min, aabb_max)            # (U,)
        key = torch.where(hit, dist[None, :], float("inf"))
        entry, idx = torch.sort(key, dim=1, stable=True)
        entry, idx = entry[:, :c], idx[:, :c]
    else:
        # Hits first in index order, then the misses in index order.
        _, idx = torch.sort((~hit).to(torch.int8), dim=1, stable=True)
        idx = idx[:, :c]
        entry = torch.zeros(idx.shape, dtype=torch.float32,
                            device=hit.device)
    count = hit.sum(dim=1).to(torch.int32)
    return (idx.to(torch.int32).contiguous(), count,
            entry.to(torch.float32).contiguous())
