"""Grouped trace for arbitrary (incoherent) rays: the path tracer's
kernel-free secondary engine (`grouped`).

Secondary bounces have no shared apex and no screen-tile coherence, so
the primary renderer's tile-frustum machinery does not apply. Instead:

  1. the caller sorts rays by direction octant and origin cell
     (_sort_key), so each contiguous group of GROUP=1024 rays points into
     a narrow cone from a small origin box (dead rays sink to the end);
  2. per group, a conservative reach box — the AABB of {o + t*d : o in
     the origin box, d in the direction box, t in [0, t_max]} — is
     overlapped with every unit's AABB;
  3. per (group, candidate) the generalized Möller-Trumbore runs as one
     batched float32 product of the ray rows [d, o x d, o, 1] with the
     unit's absolute table (unit_q16, or derived from the compressed
     record), then the closest hit by a minimum over the leaves.

The candidate list is capped (max_group_candidates, 96) and taken
front-to-back by origin-box distance, so a truncation (counted in the
overflow return) drops only the farthest candidates. The JAX package's
ops/grouped.py is the reference; ties in the candidate order go to the
lower unit index, as jax.lax.top_k gives them (a stable sort).
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from ..utils import spans
from . import _f32, compressed, culling, tiled
from .intersect import MT_UV_EPS

BIG = 1e30
GROUP = 1024
N_CELLS = 4   # origin cells per axis in the group sort key
DEAD_KEY = 8 * N_CELLS**3
# Groups per batched product: (chunk, GROUP, 5*LPU) float32 = 84 MB.
GROUP_CHUNK = 64


def _octant(d: torch.Tensor) -> torch.Tensor:
    """Direction octant id (0..7) of (n, 3) directions, int32."""
    return ((d[:, 0] > 0).to(torch.int32)
            + 2 * (d[:, 1] > 0).to(torch.int32)
            + 4 * (d[:, 2] > 0).to(torch.int32))


def _sort_key(o: torch.Tensor, d: torch.Tensor,
              scene: DeviceScene) -> torch.Tensor:
    """Direction octant + origin cell (4x4x4 over the units' bounds): rays
    of a group share a cone AND a local origin box. int32 (n,)."""
    lo = scene.unit_aabb_min.amin(dim=0)
    hi = scene.unit_aabb_max.amax(dim=0)
    scaled = torch.div(o - lo, torch.clamp_min(hi - lo, 1e-6)) * N_CELLS
    cell = torch.clamp(scaled.to(torch.int32), 0, N_CELLS - 1)
    cell_id = (cell[:, 0] + N_CELLS * cell[:, 1]
               + N_CELLS * N_CELLS * cell[:, 2])
    return _octant(d) * N_CELLS**3 + cell_id


def _tables(scene: DeviceScene, unit: torch.Tensor, corners):
    """(q16 (n, 16, 4*LPU), nrm (n, LPU, 3)) of the gathered units."""
    if scene.compressed:
        return compressed.derive_q16(scene.unit_grid[unit], corners)
    return scene.unit_q16[unit], scene.unit_nrm[unit]


def trace_sorted(scene: DeviceScene, o: torch.Tensor, d: torch.Tensor,
                 live: torch.Tensor, cfg: RenderConfig,
                 max_group_candidates: int = 96):
    """Trace pre-grouped rays: o/d (g, GROUP, 3), live (g, GROUP) bool.

    The caller owns the grouping (sort by _sort_key). Returns (best_t (g,
    GROUP) with BIG = miss, best_n (g, GROUP, 3) unnormalised, overflow: a
    0-dim int tensor, the groups whose candidate count exceeded the
    list).
    """
    g = o.shape[0]
    t_max = cfg.t_max
    lv = live[..., None]
    omin = torch.where(lv, o, BIG).amin(dim=1)                # (g, 3)
    omax = torch.where(lv, o, -BIG).amax(dim=1)
    dmin = torch.where(lv, d, BIG).amin(dim=1)
    dmax = torch.where(lv, d, -BIG).amax(dim=1)
    reach_min = omin + t_max * torch.clamp_max(dmin, 0.0)
    reach_max = omax + t_max * torch.clamp_min(dmax, 0.0)
    any_live = live.any(dim=1)
    umin, umax = scene.unit_aabb_min, scene.unit_aabb_max
    overlap = ((reach_min[:, None, :] <= umax[None])
               & (reach_max[:, None, :] >= umin[None])).all(-1)   # (g, U)
    overlap &= scene.unit_valid[None] & any_live[:, None]

    # Front-to-back by distance from the origin box (a lower bound).
    gap = torch.clamp_min(torch.maximum(umin[None] - omax[:, None, :],
                                        omin[:, None, :] - umax[None]), 0.0)
    dist = culling._norm(gap)                                 # (g, U)
    c = min(max_group_candidates, scene.num_units)
    key, cand = torch.sort(torch.where(overlap, dist, float("inf")), dim=1,
                           stable=True)
    cand, cvalid = cand[:, :c], key[:, :c] < float("inf")
    count = overlap.sum(dim=1)
    overflow = (count > c).sum()

    m = culling._cross(o, d)
    ones = torch.ones((g, GROUP, 1), dtype=torch.float32, device=o.device)
    rv = torch.cat([d, m, o, ones,
                    torch.zeros((g, GROUP, 6), dtype=torch.float32,
                                device=o.device)], dim=-1)    # (g, GROUP, 16)
    lpu = scene.leaves_per_unit
    corners = tiled.corner_lanes(scene) if scene.compressed else None
    best_t = torch.full((g, GROUP), BIG, dtype=torch.float32,
                        device=o.device)
    best_n = torch.zeros((g, GROUP, 3), dtype=torch.float32,
                         device=o.device)
    n_cand = (spans.sync("grouped.candidates", count.clamp_max(c).max())
              if g else 0)
    for g0 in range(0, g, GROUP_CHUNK):
        sl = slice(g0, g0 + GROUP_CHUNK)
        rv_c, live_c = rv[sl], live[sl]
        bt, bn = best_t[sl], best_n[sl]
        for ci in range(n_cand):
            q, nrm = _tables(scene, cand[sl, ci], corners)
            # w = det - u - v, built on the table columns before the
            # product (the kernels' w-form acceptance).
            q = torch.cat([q, (q[..., 0 * lpu:1 * lpu]
                               - q[..., 1 * lpu:2 * lpu])
                           - q[..., 2 * lpu:3 * lpu]], dim=-1)
            out = torch.bmm(rv_c, q)                          # (gc, GROUP, 5L)
            inv = _f32.rdiv(1.0, out[..., 0 * lpu:1 * lpu])
            u = out[..., 1 * lpu:2 * lpu] * inv
            v = out[..., 2 * lpu:3 * lpu] * inv
            t = out[..., 3 * lpu:4 * lpu] * inv
            ww = out[..., 4 * lpu:5 * lpu] * inv
            # Unguarded reciprocal: det == 0 lanes give inf/NaN quotients
            # that fail the window.
            ok = ((torch.minimum(torch.minimum(u, v), ww) >= -MT_UV_EPS)
                  & (t >= cfg.t_min)
                  & cvalid[sl, ci][:, None, None] & live_c[..., None])
            t = torch.where(ok, t, BIG)
            tb = t.amin(dim=2)                                # (gc, GROUP)
            tb = torch.where(tb <= t_max, tb, BIG)
            onehot = (t <= tb[..., None]).to(torch.float32)
            nb = torch.bmm(onehot, nrm)                       # (gc, GROUP, 3)
            take = tb < bt
            bt = torch.where(take, tb, bt)
            bn = torch.where(take[..., None], nb, bn)
        best_t[sl], best_n[sl] = bt, bn
    return best_t, best_n, overflow
