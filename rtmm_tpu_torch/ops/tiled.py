"""Frame prologue of the tiled renderer.

Everything the trace kernel needs per frame, built with plain tensor ops:
raygen (when a ray matrix is wanted), the tile and sub-tile frusta, the
dense tile x cluster cull, the inflated scene box that bounds every
ray's reach, and the per-tile scalar pack the kernel reads.

Because all primary rays share the camera apex, the Möller-Trumbore
quantities are bilinear in (ray, leaf) (see DeviceScene.unit_qn): with
per-pixel near-plane origins recovered as t_near = t_apex - s,
s = dot(origin - apex, d), every (tile, unit) step is a small contraction
of the unit's table with the tile's ray rows [d, m].

Scenes with more clusters than one launch's per-tile list holds are
traced in cluster windows (cluster_window, trace_windowed_clusters): each
window takes the next kc nearest clusters of every tile, and the kernel
carries the running best hit from window to window.

(The JAX package's XLA tile backend — candidate windows, trace_candidate,
render_tiled — lives in the same module there; it is not ported yet.)
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from . import culling, intersect, raygen

BIG = 1e30
TILE = culling.TILE_H * culling.TILE_W


def padded_size(width: int, height: int) -> tuple[int, int]:
    pw = -(-width // culling.TILE_W) * culling.TILE_W
    ph = -(-height // culling.TILE_H) * culling.TILE_H
    return pw, ph


class FrameInputs(NamedTuple):
    """Per-frame inputs of the trace."""

    raymat: torch.Tensor | None   # (tiles, TILE, 8) rows [d, apex x d, s, 1]
    dirs: torch.Tensor | None     # (tiles, TILE, 3)
    apex: torch.Tensor            # (3,)
    normals: torch.Tensor         # (tiles, 4, 3) tile frustum planes
    cluster_hit: torch.Tensor     # (tiles, C) bool — coarse-level cull
    sub_normals: torch.Tensor     # (tiles, cfg.sub_frusta, 4, 3)
    # (6,) inflated scene AABB [min xyz, max xyz] (scene_exit_aabb) — the
    # kernel's per-ray reach bound for rays that still miss everything.
    scene_aabb: torch.Tensor


def scene_exit_aabb(scene: DeviceScene) -> torch.Tensor:
    """(6,) f32 [min xyz, max xyz]: the union of valid cluster AABBs,
    inflated so that every hit the MT epilogue can ACCEPT (uv within
    MT_UV_EPS outside a leaf, i.e. up to ~eps * extent outside the exact
    geometry AABB) still lies inside. A ray's slab EXIT through this box
    upper-bounds the apex-relative t of any hit it may still find."""
    valid = scene.cluster_valid[:, None]
    mn = torch.where(valid, scene.cluster_aabb_min, BIG).amin(dim=0)
    mx = torch.where(valid, scene.cluster_aabb_max, -BIG).amax(dim=0)
    pad = 2.0 * intersect.MT_UV_EPS * (mx - mn) + 1e-6
    return torch.cat([mn - pad, mx + pad]).to(torch.float32)


def unit_centers(scene: DeviceScene) -> torch.Tensor:
    """(U, 3) unit AABB centers — the per-unit recentering origin of the
    MT tables. Must be 0.5*(min+max) in f32 exactly: the trace kernel
    recomputes the same value from the cluster_unit_meta rows."""
    return 0.5 * (scene.unit_aabb_min + scene.unit_aabb_max)


def frame_t_num(scene: DeviceScene, apex: torch.Tensor) -> torch.Tensor:
    """(U, LPU) per-frame t_num = (apex - c).n - e2.w2 against the
    recentered tables (c = unit AABB center), as explicit left-associated
    component products — the order the trace kernel uses."""
    ac = apex - unit_centers(scene)                       # (U, 3)
    n = scene.unit_n                                      # (U, LPU, 3)
    s = (n[..., 0] * ac[:, None, 0] + n[..., 1] * ac[:, None, 1]
         + n[..., 2] * ac[:, None, 2])
    return s - scene.unit_e2w2


def recentered_raymat(raymat: torch.Tensor,
                      centers: torch.Tensor) -> torch.Tensor:
    """Swap the moment rows of gathered ray matrices to per-unit frames.

    raymat: (nt, TILE, 8) rows [d, m, s, 1] with m = a x d; centers:
    (nt, 3). Returns raymat with m' = (a - c) x d = m - c x d."""
    d = raymat[..., 0:3]
    m2 = raymat[..., 3:6] - culling._cross(
        centers[:, None, :].expand_as(d), d)
    return torch.cat([d, m2, raymat[..., 6:8]], dim=-1)


def build_frame_inputs(scene: DeviceScene, inv_view_proj,
                       cfg: RenderConfig,
                       need_rays: bool = True) -> FrameInputs:
    """Raygen + the coarse (cluster-level) cull, on the scene's device.

    need_rays=False skips raygen and the ray-matrix build (raymat/dirs
    come back None) — the trace kernel generates its rays in-kernel from
    the inv-view-proj scalars of the frustum pack.
    """
    dev = scene.device
    width, height = cfg.width, cfg.height
    pw, ph = padded_size(width, height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    n_tiles = tx * ty

    apex, normals = culling.tile_frustums(inv_view_proj, width, height,
                                          pw, ph, device=dev)
    sub_normals = culling.tile_sub_frustums(inv_view_proj, width, height,
                                            pw, ph, n_sub=cfg.sub_frusta,
                                            n_rows=cfg.sub_rows, device=dev)
    cluster_hit = culling.cull_units(apex, normals, scene.cluster_aabb_min,
                                     scene.cluster_aabb_max,
                                     scene.cluster_valid)

    raymat = dirs = None
    if need_rays:
        origins, dirs = raygen.generate_rays(inv_view_proj, width, height,
                                             pw, ph, device=dev)

        def to_tiles(x):
            return (x.reshape(ty, culling.TILE_H, tx, culling.TILE_W, 3)
                    .permute(0, 2, 1, 3, 4).reshape(n_tiles, TILE, 3))

        dirs = to_tiles(dirs)
        origins = to_tiles(origins)
        m = culling._cross(apex.expand_as(dirs), dirs)
        oa = origins - apex
        s = (oa[..., 0] * dirs[..., 0] + oa[..., 1] * dirs[..., 1]
             + oa[..., 2] * dirs[..., 2])
        raymat = torch.cat(
            [dirs, m, s[..., None], torch.ones_like(s)[..., None]], dim=-1)
    return FrameInputs(raymat, dirs, apex, normals, cluster_hit,
                       sub_normals, scene_exit_aabb(scene))


def frustum_pack_len(n_sub: int, with_raygen: bool = False,
                     with_xform: bool = False) -> int:
    """Length of the per-tile frustum scalar pack (rounded up to 64).
    with_xform: the merged-instancing pack appends an object transform
    block [R^T (9), inv_s (1), apex_w (3)] after the scene AABB (implies
    with_raygen)."""
    return -(-(3 + n_sub * 12 + (18 if with_raygen or with_xform else 0)
               + 6 + (13 if with_xform else 0)) // 64) * 64


def frustum_scalars(fi: FrameInputs, raygen_ivp=None,
                    tx: int | None = None) -> torch.Tensor:
    """(tiles, frustum_pack_len(...)) f32 per-tile scalar pack for the
    kernel: [apex xyz, n_sub sub-cones x 4 planes x xyz, then — for
    in-kernel raygen — the tile's pixel origin (px0, py0) and the 16
    inv-view-proj scalars, then the 6 inflated scene-AABB scalars
    (fi.scene_aabb — the kernel's per-ray reach bound), pad]."""
    n_tiles = fi.normals.shape[0]
    n_sub = fi.sub_normals.shape[1]
    ns = n_sub * 12
    dev = fi.apex.device
    apex = fi.apex.expand(n_tiles, 3)
    parts = [apex, fi.sub_normals.reshape(n_tiles, ns)]
    used = 3 + ns
    if raygen_ivp is not None:
        # Integer tile coordinates, exact in float32.
        tile = torch.arange(n_tiles, dtype=torch.int64, device=dev)
        px0 = ((tile % tx) * culling.TILE_W).to(torch.float32)
        py0 = ((tile // tx) * culling.TILE_H).to(torch.float32)
        m16 = torch.as_tensor(raygen_ivp, dtype=torch.float32,
                              device=dev).reshape(16).expand(n_tiles, 16)
        parts += [px0[:, None], py0[:, None], m16]
        used += 18
    parts.append(fi.scene_aabb.expand(n_tiles, 6))
    used += 6
    pack = frustum_pack_len(n_sub, raygen_ivp is not None)
    parts.append(torch.zeros((n_tiles, pack - used), dtype=torch.float32,
                             device=dev))
    return torch.cat(parts, dim=1).contiguous()


def _select_nearest_clusters(cl_dist: torch.Tensor, remaining: torch.Tensor,
                             kc: int):
    """Per-tile kc nearest remaining clusters + the cleared remaining set.
    cl_dist is (C,), one apex for every tile, or (tiles, C), an apex per
    row (merged instancing).

    Selection is by (distance, cluster index) order, as jax.lax.top_k
    gives it (ties to the lower index): a stable ascending sort of the
    distances. "Clear the selected clusters" is a per-tile threshold
    compare against the last selected (distance, index) pair, O(tiles x
    C), not a (tiles, kc, C) membership tensor.

    Returns (cidx (tiles, kc) int32, sel (tiles, kc) bool, ascending
    distance skey (tiles, kc) f32 (+inf where not sel), new_remaining
    (tiles, C) bool, next_bound (tiles,) f32).
    """
    n_cl = remaining.shape[1]
    kc = min(kc, n_cl)
    idx = torch.arange(n_cl, device=cl_dist.device)
    d = cl_dist if cl_dist.dim() == 2 else cl_dist[None, :]
    keyed = torch.where(remaining, d, float("inf"))
    skey, sidx = torch.sort(keyed, dim=1, stable=True)
    skey, sidx = skey[:, :kc], sidx[:, :kc]
    sel = skey < float("inf")
    # Strictly after the kc-th selected pair in (dist, idx) order; when
    # fewer than kc survived, everything remaining was selected, so the
    # threshold is +inf (nothing stays).
    kth_d = torch.where(sel[:, -1], skey[:, -1], float("inf"))[:, None]
    kth_i = torch.where(sel[:, -1], sidx[:, -1], n_cl)[:, None]
    new_remaining = remaining & ((d > kth_d)
                                 | ((d == kth_d) & (idx[None, :] > kth_i)))
    next_bound = torch.where(new_remaining, d, float("inf")).amin(dim=1)
    return (sidx.to(torch.int32), sel, skey, new_remaining, next_bound)


def cluster_window(scene: DeviceScene, apex: torch.Tensor,
                   remaining: torch.Tensor, kc: int):
    """Cluster-level window: the kc nearest remaining clusters per tile,
    front-to-back, for the kernel's in-kernel unit walk.

    Returns (ccand (tiles, kc) int32, ccount (tiles,) int32, centry
    (tiles, kc) f32 ascending with +inf tail, new_remaining, next_bound
    (tiles,))."""
    cl_dist = culling.aabb_distance(apex, scene.cluster_aabb_min,
                                    scene.cluster_aabb_max)          # (C,)
    cidx, sel, skey, new_remaining, next_bound = _select_nearest_clusters(
        cl_dist, remaining, kc)
    return (cidx.contiguous(), sel.sum(dim=1).to(torch.int32),
            skey.contiguous(), new_remaining, next_bound)


def trace_windowed_clusters(scene: DeviceScene, fi: FrameInputs,
                            trace_window: Callable, init_t: torch.Tensor,
                            init_n, kc: int):
    """Cluster-granular window loop: trace_window receives (ccand,
    ccount, centry, best_t, best_n) and returns the updated (best_t,
    best_n); best_t is (tiles, TILE) apex-relative t (BIG = miss), best_n
    whatever the window carries besides.

    A tile stays active while it has unprocessed clusters and some ray
    could still improve: its worst reach (hit t + s, or the ray's exit t
    through the inflated scene box while it misses) is at least the
    nearest remaining cluster's entry distance. The loop runs on the host,
    one sync per window. Returns (best_t, best_n, number of windows)."""
    s_apex = fi.raymat[..., 6]
    # Per-ray scene-exit reach (the bound the kernel applies in its
    # worst_subs): miss rays stop holding their tile's worst at +inf.
    d = fi.raymat[..., 0:3]
    tiny = 1e-12
    ds = torch.where(torch.abs(d) < tiny,
                     torch.where(d >= 0.0, tiny, -tiny), d)
    t0 = torch.div(fi.scene_aabb[0:3] - fi.apex, ds)
    t1 = torch.div(fi.scene_aabb[3:6] - fi.apex, ds)
    exit_t = torch.maximum(t0, t1).amin(dim=-1)          # (tiles, TILE)

    active = fi.cluster_hit.any(dim=1)
    remaining = fi.cluster_hit & active[:, None]
    best_t, best_n = init_t, init_n
    windows = 0
    while bool(active.any()):
        ccand, ccount, centry, remaining, bound = cluster_window(
            scene, fi.apex, remaining, kc)
        best_t, best_n = trace_window(ccand, ccount, centry, best_t, best_n)
        windows += 1
        worst = torch.where(best_t < BIG, best_t + s_apex,
                            exit_t).amax(dim=1)
        active = remaining.any(dim=1) & (worst >= bound)
        remaining = remaining & active[:, None]
    return best_t, best_n, windows
