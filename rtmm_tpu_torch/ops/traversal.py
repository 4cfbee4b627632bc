"""Per-ray micro-mesh traversal — the reference backend (the reference's
DXR intersection shader, shaders/intersection.hlsl:454-559, reformulated
as level-synchronous mask propagation).

The reference runs, per ray and per AABB hit, a 256-deep explicit stack with
nearest-first bubble sorting and first-hit early exit. Here every lane of a
batch walks the precomputed hierarchy tables breadth first:

  level 0..L-1: active[l][n] = active[l-1][n >> 2] AND node_test(n)
  leaves:       candidate iff leaf_mask AND active[L-1][slot >> 2]
  hit:          masked Möller-Trumbore, min-reduce over t

`node_test` is the exact pruning predicate of the reference (expanded 2D
triangle crossing + displacement height band, intersection.hlsl:398); the
nearest-first ordering + early exit is replaced by an exact min-reduction
over all surviving leaves (a safe superset — same closest hit). The one
cut is the candidate list: a ray walks the cfg.max_candidates base
triangles whose AABBs it enters first (the JAX package's top-k); with
max_candidates at least the most AABBs any ray enters (aabb_hit_counts)
the trace is exact.

The level loop and the leaf-block loop are Python loops over tensors on
the rays' device, with no host sync: a batch is one stream of launches.
This backend is the oracle the tile kernel and the grouped engines are
held against, not a fast path.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from . import _f32, intersect
from .subdivision import level_offset

BIG = 1e30


def trace(scene: DeviceScene, origins: torch.Tensor, directions: torch.Tensor,
          cfg: RenderConfig):
    """Trace a batch of rays against the scene.

    origins/directions: (N, 3) on the scene's device. Returns (t (N,),
    normal (N, 3), hit (N,)): t is cfg.t_max where the ray misses.
    Replaces TraceRay + the whole DXR shader-table machinery
    (src/application.cpp:214, src/dx_util/RayTraceShader.cpp:345-372).
    """
    t, nrm, hit, _ = trace_with_steps(scene, origins, directions, cfg)
    return t, nrm, hit


def trace_with_steps(scene: DeviceScene, origins: torch.Tensor,
                     directions: torch.Tensor, cfg: RenderConfig):
    """trace() plus a per-ray traversal-step count: the number of hierarchy
    nodes that survived pruning plus the leaf Möller-Trumbore tests run —
    the divergence metric of the reference's per-ray stack loop
    (intersection.hlsl:462-476), per pixel. Returns (t, normal, hit,
    steps (N,) int32)."""
    if scene.compressed:
        raise ValueError(
            "the per-ray reference backend reads the leaf/hierarchy "
            "tables, which compressed scenes do not materialize; use the "
            "tile/pallas pipelines or build with compressed=False")
    if scene.node_verts is None and scene.max_level > 0:
        raise ValueError(
            "per-ray traversal needs the hierarchy tables; this scene was "
            "built with hierarchy=False (production tile/pallas builds). "
            "Rebuild with build_device_scene(..., hierarchy=True).")
    n = origins.shape[0]
    dev = origins.device
    k = min(cfg.max_candidates, scene.num_triangles)

    score = _candidate_scores(scene, origins, directions)    # (N, T)
    # The k nearest in (t_entry, triangle index) order: jax.lax.top_k puts
    # the lower index first among equal scores, which a stable ascending
    # sort reproduces (torch.topk promises no tie order).
    score, cand_idx = torch.sort(score, dim=1, stable=True)
    cand_valid = score[:, :k] < BIG                          # (N, K)
    cand_idx = cand_idx[:, :k]

    # --- per-candidate traversal, running closest hit over the K slots ---
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_n = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    for slot in range(k):
        t, nrm, st = _trace_one_candidate(scene, origins, directions,
                                          cand_idx[:, slot], cfg)
        valid = cand_valid[:, slot]
        steps = steps + torch.where(valid, st, 0)
        take = valid & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_n = torch.where(take[:, None], nrm, best_n)
    hit = best_t < BIG
    return torch.where(hit, best_t, cfg.t_max), best_n, hit, steps


def _candidate_scores(scene: DeviceScene, origins, directions):
    """The software TLAS: a slab test of every ray against every base
    triangle's AABB. (N, T) entry t, BIG where the ray misses the box."""
    safe_dir = torch.where(torch.abs(directions) < 1e-12, 1e-12, directions)
    inv_dir = _f32.rdiv(1.0, safe_dir)
    hit_aabb, t_entry = intersect.ray_aabb(
        origins[:, None, :], inv_dir[:, None, :],
        scene.aabb_min[None], scene.aabb_max[None])
    hit_aabb &= scene.tri_valid[None, :]
    return torch.where(hit_aabb, t_entry, BIG)


def aabb_hit_counts(scene: DeviceScene, origins, directions):
    """(N,) int32: the base-triangle AABBs each ray enters. The traversal
    considers the cfg.max_candidates nearest of them; a frame whose rays
    all enter at most that many is traced exactly, with no candidate
    left out."""
    return (_candidate_scores(scene, origins, directions) < BIG).sum(
        dim=1, dtype=torch.int32)


def _trace_one_candidate(scene: DeviceScene, origins, directions, tri, cfg):
    """Traverse one (ray, base-triangle) candidate per lane. tri: (N,)."""
    o2, d2, h0, hslope = intersect.project_ray_2d(
        origins, directions,
        scene.plane_t[tri], scene.plane_b[tri],
        scene.plane_n[tri], scene.plane_o[tri])
    n = tri.shape[0]
    dev = origins.device
    level = scene.max_level

    # Breadth-first mask propagation over internal levels (level <= 5 as
    # in the reference, intersection.hlsl:79).
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    active = torch.ones((n, 1), dtype=torch.bool, device=dev)
    for lv in range(level):
        nodes = slice(level_offset(lv), level_offset(lv) + 4**lv)
        nv = scene.node_verts[tri, nodes]                   # (N, cnt, 3, 2)
        nm = scene.node_minmax[tri, nodes]                  # (N, cnt, 2)
        npass = scene.node_pass[tri, nodes]                 # (N, cnt)
        ok = npass | intersect.node_test(
            o2[:, None], d2[:, None], nv, nm, h0[:, None], hslope[:, None])
        parent = (active if lv == 0
                  else torch.repeat_interleave(active, 4, dim=1))
        active = parent & ok
        steps = steps + active.sum(dim=1, dtype=torch.int32)
    nf = scene.num_leaf_slots
    if level > 0:
        leaf_active = torch.repeat_interleave(active, 4, dim=1)
        # Leaf slots are padded to a multiple of 64 (traversal-unit
        # alignment); padding slots beyond 4^L are never valid.
        pad = nf - leaf_active.shape[1]
        if pad > 0:
            leaf_active = torch.cat([leaf_active, torch.zeros(
                (n, pad), dtype=torch.bool, device=dev)], dim=1)
    else:
        leaf_active = torch.ones((n, nf), dtype=torch.bool, device=dev)

    # Masked Möller-Trumbore over leaf blocks with a running min. Ceil
    # division: nf need not be a blk multiple (a mixed-level tessellated
    # scene has e.g. 1,008 slots). The last block's start clamps to nf -
    # blk, as the JAX package's dynamic_slice does, re-testing a few slots:
    # the min absorbs them, and the step count counts them twice, as there.
    blk = min(nf, 256)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_n = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for i in range(-(-nf // blk)):
        start = min(i * blk, nf - blk)
        leaves = slice(start, start + blk)
        lv = scene.leaf_verts[tri, leaves]                  # (N, blk, 3, 3)
        tested = scene.leaf_mask[tri, leaves] & leaf_active[:, leaves]
        steps = steps + tested.sum(dim=1, dtype=torch.int32)
        ok, t, nrm = intersect.moller_trumbore(
            origins[:, None], directions[:, None],
            lv[:, :, 0], lv[:, :, 1], lv[:, :, 2])
        valid = ok & tested & (t >= cfg.t_min) & (t <= cfg.t_max)
        t = torch.where(valid, t, BIG)
        # The first index of the minimum (jnp.argmin and torch.argmin
        # agree), then a strict < against the running best.
        idx = torch.argmin(t, dim=1)
        tb = torch.gather(t, 1, idx[:, None])[:, 0]
        nb = torch.gather(nrm, 1, idx[:, None, None].expand(n, 1, 3))[:, 0]
        take = tb < best_t
        best_t = torch.where(take, tb, best_t)
        best_n = torch.where(take[:, None], nb, best_n)
    return best_t, best_n, steps
