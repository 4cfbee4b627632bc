"""Ray-primitive intersection tests (broadcastable tensors).

Ports the reference's intersection math with identical epsilons:
  - slab AABB test (the hardware TLAS/BLAS traversal analog,
    src/GPUMesh.cpp:154-192 builds procedural AABBs; tested in software)
  - 2D ray-vs-edge (shaders/intersection.hlsl:204-222)
  - height-band displacement-region test (intersection.hlsl:55-68, 257-269)
  - Möller-Trumbore (intersection.hlsl:412-442)

Dot products, cross products and norms are written out by component,
summed left to right, and every division goes through ops/_f32.py, so the
same inputs round the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

from . import _f32

MAX_T = 100000.0        # intersection.hlsl:99
EDGE_PARALLEL_EPS = 1e-6  # intersection.hlsl:211
BAND_EPS = 1e-4         # intersection.hlsl:263
MT_UV_EPS = 1e-3        # intersection.hlsl:413
MT_DET_EPS = 1e-8       # intersection.hlsl:423


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of size 3, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, the component formula of jnp.cross."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def ray_aabb(origin, inv_dir, aabb_min, aabb_max):
    """Slab test. origin/inv_dir (..., 3); aabb (..., 3). Returns (hit, t_entry).

    Padded triangles carry inverted AABBs (min > max) and fail automatically.
    """
    t0 = (aabb_min - origin) * inv_dir
    t1 = (aabb_max - origin) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    # Inverted (padding-sentinel) boxes can overflow to +-inf in the slab
    # arithmetic and spuriously pass; reject them explicitly.
    valid = (aabb_min <= aabb_max).all(dim=-1)
    hit = valid & (t_near <= t_far) & (t_far >= 0.0)
    return hit, t_near


def ray_edge_2d(o2, d2, start, end):
    """rayIntersectsEdge (intersection.hlsl:204-222).

    o2/d2: (..., 2) 2D ray (d2 normalized); start/end: (..., 2).
    Returns (hit, t) with t = -1 where no hit (the reference's inout
    convention: ts stay -1 when an edge is missed, intersection.hlsl:377).
    """
    v1x, v1y = o2[..., 0] - start[..., 0], o2[..., 1] - start[..., 1]
    v2x, v2y = end[..., 0] - start[..., 0], end[..., 1] - start[..., 1]
    v3x, v3y = -d2[..., 1], d2[..., 0]
    denom = v2x * v3x + v2y * v3y
    parallel = torch.abs(denom) < EDGE_PARALLEL_EPS
    safe = torch.where(parallel, 1.0, denom)
    t1 = torch.div(v2x * v1y - v2y * v1x, safe)
    t2 = torch.div(v1x * v3x + v1y * v3y, safe)
    hit = ~parallel & (t1 >= 0.0) & (t2 >= 0.0) & (t2 <= 1.0)
    return hit, torch.where(hit, t1, -1.0)


def node_test(o2, d2, verts, minmax, h0, hslope):
    """One hierarchy-node pruning test.

    verts: (..., 3, 2) expanded displaced 2D node triangle; minmax: (..., 2);
    h0/hslope: (...,) affine height-along-ray coefficients (closed form of
    Ray2D::heightTo3DRay, intersection.hlsl:55-68: height(t2d) = h0 +
    t2d * dot(D, N)/|D_planar|).

    Returns active: ray crosses the node's expanded 2D triangle AND is not
    outside the displacement band (intersection.hlsl:249-269, 398).
    """
    hits, ts = [], []
    for i, j in ((0, 1), (1, 2), (2, 0)):
        h, t = ray_edge_2d(o2, d2, verts[..., i, :], verts[..., j, :])
        hits.append(h)
        ts.append(t)
    tri_hit = hits[0] | hits[1] | hits[2]
    ts = torch.stack(ts, dim=-1)                       # (..., 3)
    entry = torch.where(ts < 0.0, MAX_T, ts).amin(dim=-1)
    exit_ = ts.amax(dim=-1)
    h_entry = h0 + entry * hslope
    h_exit = h0 + exit_ * hslope
    mn = minmax[..., 0]
    mx = minmax[..., 1]
    outside = ((torch.abs(entry - exit_) >= BAND_EPS)
               & (((h_entry < mn) & (h_exit < mn))
                  | ((h_entry > mx) & (h_exit > mx))))
    return tri_hit & ~outside


def moller_trumbore(origin, direction, v0, v1, v2):
    """rayTraceTriangle (intersection.hlsl:412-442) with identical epsilons.

    origin/direction: (..., 3); v0/v1/v2: (..., 3).
    Returns (hit, t, normal) — normal = normalize(cross(e1, e2)), un-flipped,
    exactly as the reference reports to the closest-hit shader.

    The reciprocal is unguarded, as on every backend of the JAX package by
    default: det == 0 yields Inf/NaN u/v, which the uv windows reject (NaN
    compares False), so the acceptance set is the tile and kernel paths'.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec)
    inv_det = _f32.rdiv(1.0, det)
    tvec = origin - v0
    u = dot3(tvec, pvec) * inv_det
    ok = (u >= -MT_UV_EPS) & (u <= 1.0 + MT_UV_EPS)
    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec) * inv_det
    ok &= (v >= -MT_UV_EPS) & (u + v <= 1.0 + MT_UV_EPS)
    t = dot3(e2, qvec) * inv_det
    n = cross3(e1, e2)
    norm = torch.sqrt(dot3(n, n))
    n = torch.div(n, torch.clamp_min(norm, 1e-20)[..., None])
    return ok, t, n


def project_ray_2d(origin, direction, plane_t, plane_b, plane_n, plane_o):
    """Project a 3D ray onto a base-triangle plane (intersection.hlsl:520-531).

    Returns (o2, d2, h0, hslope): 2D ray origin, normalized 2D direction and
    the affine height coefficients height(t2d) = h0 + t2d * hslope.
    """
    rel = origin - plane_o
    o2 = torch.stack([dot3(rel, plane_t), dot3(rel, plane_b)], dim=-1)
    dx, dy = dot3(direction, plane_t), dot3(direction, plane_b)
    len_plane = torch.clamp_min(torch.sqrt(dx * dx + dy * dy), 1e-12)
    d2 = torch.stack([torch.div(dx, len_plane), torch.div(dy, len_plane)],
                     dim=-1)
    h0 = dot3(rel, plane_n)
    hslope = torch.div(dot3(direction, plane_n), len_plane)
    return o2, d2, h0, hslope
