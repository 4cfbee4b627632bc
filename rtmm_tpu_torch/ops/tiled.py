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

The XLA tile backend (the JAX package's "tile" pipeline, and the primary
trace of the path tracer's `grouped` engine) lives here too, kernel-free:
candidate_window refines each window's clusters to a front-to-back unit
list per tile, candidate_group prepares a group of candidate slots (the
units' per-frame tables, gathered or derived, and the recentered rays),
trace_candidate runs one candidate slot of every tile as a batched matrix
product of the ray rows with the unit's table (float32; TF32 stays off),
and xla_trace_frame / render_tiled drive the windows. Its semantics are the shipped ones of the JAX package: w-form
acceptance, no det guard, the p-form t-window.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from ..utils import spans
from . import _f32, compressed, culling, intersect, prologue, raygen, shading

BIG = 1e30
TILE = culling.TILE_H * culling.TILE_W
UPC = culling.UNITS_PER_CLUSTER


def padded_size(width: int, height: int) -> tuple[int, int]:
    pw = -(-width // culling.TILE_W) * culling.TILE_W
    ph = -(-height // culling.TILE_H) * culling.TILE_H
    return pw, ph


class FrameInputs(NamedTuple):
    """Per-frame inputs of the trace. Built for F frames in one pass
    (build_frame_inputs of an (F, 4, 4) inv_view_proj), every field but
    scene_aabb has a leading frame axis (apex (F, 3), normals (F, tiles,
    4, 3), ...) and the ray and q_frame fields are None."""

    raymat: torch.Tensor | None   # (tiles, TILE, 8) rows [d, apex x d, s, 1]
    dirs: torch.Tensor | None     # (tiles, TILE, 3)
    apex: torch.Tensor            # (3,)
    normals: torch.Tensor         # (tiles, 4, 3) tile frustum planes
    cluster_hit: torch.Tensor     # (tiles, C) bool — coarse-level cull
    sub_normals: torch.Tensor     # (tiles, cfg.sub_frusta, 4, 3)
    # (6,) inflated scene AABB [min xyz, max xyz] (scene_exit_aabb) — the
    # kernel's per-ray reach bound for rays that still miss everything.
    scene_aabb: torch.Tensor
    # XLA tile backend only (need_q_frame): unit_qn with this frame's
    # t_num in row 7 of the t block, and t_num (U, LPU) itself. None on the
    # kernel paths (the kernel forms t_num per visit) and for compressed
    # scenes (trace_candidate derives the table per candidate).
    q_frame: torch.Tensor | None = None
    t_num: torch.Tensor | None = None
    # The kernel paths' per-tile scalar pack without raygen scalars
    # (frustum_scalars(fi)), built with the frusta (kernels=True).
    frus: torch.Tensor | None = None


def scene_exit_aabb(scene: DeviceScene) -> torch.Tensor:
    """(6,) f32 inflated scene box [min xyz, max xyz]: the kernel's per-ray
    reach bound (DeviceScene.exit_aabb, computed once per scene)."""
    return scene.exit_aabb


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
    (..., nt, 3), one unit per tile for each leading index. Returns (...,
    nt, TILE, 8) with m' = (a - c) x d = m - c x d."""
    c, rm = torch.broadcast_tensors(centers[..., None, :], raymat[..., 0:3])
    m2 = raymat[..., 3:6] - culling._cross(c, rm)
    return torch.cat([rm, m2, raymat[..., 6:8].expand(rm.shape[:-1] + (2,))],
                     dim=-1)


def build_frame_inputs(scene: DeviceScene, inv_view_proj,
                       cfg: RenderConfig,
                       need_rays: bool = True,
                       need_q_frame: bool = False,
                       tiles: tuple[int, int] | None = None,
                       kernels: bool = False) -> FrameInputs:
    """Raygen + the coarse (cluster-level) cull, on the scene's device.

    need_rays=False skips raygen and the ray-matrix build (raymat/dirs
    come back None) — the trace kernel generates its rays in-kernel from
    the inv-view-proj scalars of the frustum pack. need_q_frame=True also
    builds the XLA tile backend's per-frame table q_frame (a copy of
    unit_qn; compressed scenes have none). The kernel paths leave it off,
    which is why the default differs from the JAX package's.

    tiles = (first, count) of the flat tile index: the prologue of those
    tiles only (a rank's share of a multi-device frame). Their frustums
    are cut before the cull, and rays are made only for the tile rows
    they span; every value equals the whole frame's at those tiles.

    inv_view_proj (F, 4, 4) builds F frames in one pass, as the JAX
    package's jax.vmap of it does (render_pallas_frames): every field
    but scene_aabb gains a leading frame axis, each frame's values bit for
    bit its own call's. Rays and q_frame are built for one frame only.

    kernels=True builds the frusta, the pack (fi.frus) and the cluster
    cull with the prologue kernels (ops/prologue.py: tile_frusta,
    cluster_select), the trace kernel paths' prologue; False with their
    plain versions and no pack, as the XLA tile backend does. Both give
    the same values.
    """
    dev = scene.device
    width, height = cfg.width, cfg.height
    pw, ph = padded_size(width, height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    tile0, n_tiles = (0, tx * ty) if tiles is None else tiles
    m = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=dev)
    if m.dim() != 2 and (need_rays or need_q_frame):
        raise ValueError("rays and q_frame are built for one frame: pass "
                         f"one (4, 4) inv_view_proj, not {tuple(m.shape)}")

    frusta, select = ((prologue.tile_frusta, prologue.cluster_select)
                      if kernels else (prologue.tile_frusta_plain,
                                       prologue.cluster_select_plain))
    apex, normals, sub_normals, frus = frusta(
        m, width, height, pw, ph, cfg.sub_frusta, cfg.sub_rows,
        tiles=(tile0, n_tiles), pack="plain" if kernels else None,
        scene_aabb=scene.exit_aabb)
    cluster_hit = select(
        apex.reshape(-1, 3), normals.reshape(-1, 4, 3),
        scene.cluster_aabb_min, scene.cluster_aabb_max, scene.cluster_valid,
        0, rows_per_apex=n_tiles, want_hit=True).hit.reshape(
            *normals.shape[:-2], scene.num_clusters)

    raymat = dirs = None
    if need_rays:
        # The tile rows that hold the tiles, then the tiles among them.
        ty0 = tile0 // tx
        n_ty = -(-(tile0 + n_tiles) // tx) - ty0
        origins, dirs = raygen.generate_rays(
            m, width, height, pw, ph, device=dev,
            rows=(ty0 * culling.TILE_H, n_ty * culling.TILE_H))
        first = tile0 - ty0 * tx

        def to_tiles(x):
            return (x.reshape(n_ty, culling.TILE_H, tx, culling.TILE_W, 3)
                    .permute(0, 2, 1, 3, 4).reshape(n_ty * tx, TILE, 3)
                    [first:first + n_tiles])

        dirs = to_tiles(dirs)
        origins = to_tiles(origins)
        m = culling._cross(apex.expand_as(dirs), dirs)
        oa = origins - apex
        s = (oa[..., 0] * dirs[..., 0] + oa[..., 1] * dirs[..., 1]
             + oa[..., 2] * dirs[..., 2])
        raymat = torch.cat(
            [dirs, m, s[..., None], torch.ones_like(s)[..., None]], dim=-1)
    q_frame = t_num = None
    if need_q_frame and not scene.compressed:
        # t_num = (a-c).n - e2.w2 — ray-independent, apex-dependent.
        t_num = frame_t_num(scene, apex)                      # (U, LPU)
        lpu = scene.leaves_per_unit
        q_frame = scene.unit_qn.clone()
        q_frame[:, 7, 3 * lpu:4 * lpu] = t_num
    return FrameInputs(raymat, dirs, apex, normals, cluster_hit,
                       sub_normals, scene.exit_aabb, q_frame, t_num, frus)


def frustum_pack_len(n_sub: int, with_raygen: bool = False,
                     with_xform: bool = False) -> int:
    """Length of the per-tile frustum scalar pack (rounded up to 64).
    with_xform: the merged-instancing pack appends an object transform
    block [R^T (9), inv_s (1), apex_w (3)] after the scene AABB (implies
    with_raygen)."""
    return -(-(3 + n_sub * 12 + (18 if with_raygen or with_xform else 0)
               + 6 + (13 if with_xform else 0)) // 64) * 64


@functools.lru_cache(maxsize=16)
def _tile_origins(n_tiles: int, tx: int, device: torch.device):
    """(n_tiles, 2) f32 pixel origins (px0, py0) of the flat tile index,
    integer-valued and exact in float32. Shape-only, so built once per
    tile grid and device (callers only read it)."""
    tile = torch.arange(n_tiles, dtype=torch.int64, device=device)
    return torch.stack([(tile % tx) * culling.TILE_W,
                        (tile // tx) * culling.TILE_H],
                       dim=1).to(torch.float32)


def frustum_scalars(fi: FrameInputs, raygen_ivp=None,
                    tx: int | None = None) -> torch.Tensor:
    """(tiles, frustum_pack_len(...)) f32 per-tile scalar pack for the
    kernel: [apex xyz, n_sub sub-cones x 4 planes x xyz, then — for
    in-kernel raygen — the tile's pixel origin (px0, py0) and the 16
    inv-view-proj scalars, then the 6 inflated scene-AABB scalars
    (fi.scene_aabb — the kernel's per-ray reach bound), pad]. A batched
    fi (leading frame axis F, raygen_ivp (F, 4, 4)) gives (F, tiles,
    pack)."""
    lead = fi.apex.shape[:-1]
    n_tiles = fi.normals.shape[-3]
    n_sub = fi.sub_normals.shape[-3]
    ns = n_sub * 12
    dev = fi.apex.device
    rows = (*lead, n_tiles)
    parts = [fi.apex[..., None, :].expand(*rows, 3),
             fi.sub_normals.reshape(*rows, ns)]
    used = 3 + ns
    if raygen_ivp is not None:
        m16 = torch.as_tensor(raygen_ivp, dtype=torch.float32,
                              device=dev).reshape(*lead, 1, 16)
        parts += [_tile_origins(n_tiles, tx, dev).expand(*rows, 2),
                  m16.expand(*rows, 16)]
        used += 18
    parts.append(fi.scene_aabb.expand(*rows, 6))
    used += 6
    pack = frustum_pack_len(n_sub, raygen_ivp is not None)
    parts.append(torch.zeros((*rows, pack - used), dtype=torch.float32,
                             device=dev))
    return torch.cat(parts, dim=-1).contiguous()


def _select_nearest_clusters(cl_dist: torch.Tensor, remaining: torch.Tensor,
                             kc: int):
    """Per-tile kc nearest remaining clusters + the cleared remaining set.
    remaining is (..., tiles, C); cl_dist broadcasts against it: (C,), one
    apex for every tile; (tiles, C), an apex per row (merged instancing);
    (F, 1, C), an apex per frame of a batch.

    Selection is by (distance, cluster index) order, as jax.lax.top_k
    gives it (ties to the lower index): a stable ascending sort of the
    distances. "Clear the selected clusters" is a per-tile threshold
    compare against the last selected (distance, index) pair, O(tiles x
    C), not a (tiles, kc, C) membership tensor.

    Returns (cidx (..., tiles, kc) int32, sel (..., tiles, kc) bool,
    ascending distance skey (..., tiles, kc) f32 (+inf where not sel),
    new_remaining (..., tiles, C) bool, next_bound (..., tiles) f32).
    """
    n_cl = remaining.shape[-1]
    kc = min(kc, n_cl)
    idx = torch.arange(n_cl, device=cl_dist.device)
    keyed = torch.where(remaining, cl_dist, float("inf"))
    skey, sidx = torch.sort(keyed, dim=-1, stable=True)
    skey, sidx = skey[..., :kc], sidx[..., :kc]
    sel = skey < float("inf")
    # Strictly after the kc-th selected pair in (dist, idx) order; when
    # fewer than kc survived, everything remaining was selected, so the
    # threshold is +inf (nothing stays).
    kth_d = torch.where(sel[..., -1], skey[..., -1], float("inf"))[..., None]
    kth_i = torch.where(sel[..., -1], sidx[..., -1], n_cl)[..., None]
    new_remaining = remaining & ((cl_dist > kth_d)
                                 | ((cl_dist == kth_d) & (idx > kth_i)))
    next_bound = torch.where(new_remaining, cl_dist,
                             float("inf")).amin(dim=-1)
    return (sidx.to(torch.int32), sel, skey, new_remaining, next_bound)


def cluster_window(scene: DeviceScene, apex: torch.Tensor,
                   remaining: torch.Tensor, kc: int, window: bool = True):
    """Cluster-level window: the kc nearest remaining clusters per tile,
    front-to-back, for the kernel's in-kernel unit walk. apex (3,) with
    remaining (tiles, C), or apex (F, 3) with remaining (F, tiles, C) for
    F frames in one pass (each frame's rows bit for bit its own call's).
    One cluster_select launch (ops/prologue.py) on the card.

    Returns (ccand (..., tiles, kc) int32, ccount (..., tiles) int32,
    centry (..., tiles, kc) f32 ascending with +inf tail, new_remaining,
    next_bound (..., tiles)); window=False leaves the last two None (the
    lists alone, as top_k gives them)."""
    apex = apex.reshape(-1, 3)
    lead, n_cl = remaining.shape[:-1], remaining.shape[-1]
    sel = prologue.cluster_select(
        apex, None, scene.cluster_aabb_min, scene.cluster_aabb_max, None,
        kc, remaining=remaining.reshape(-1, n_cl),
        rows_per_apex=lead.numel() // apex.shape[0], window=window)
    k = sel.ccand.shape[-1]
    new_remaining = next_bound = None
    if window:
        new_remaining = sel.new_remaining.reshape(remaining.shape)
        next_bound = sel.next_bound.reshape(lead)
    return (sel.ccand.reshape(*lead, k), sel.ccount.reshape(lead),
            sel.centry.reshape(*lead, k), new_remaining, next_bound)


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
    while spans.sync("tiled.cluster_window", active.any(), bool):
        ccand, ccount, centry, remaining, bound = cluster_window(
            scene, fi.apex, remaining, kc)
        best_t, best_n = trace_window(ccand, ccount, centry, best_t, best_n)
        windows += 1
        worst = torch.where(best_t < BIG, best_t + s_apex,
                            exit_t).amax(dim=1)
        active = remaining.any(dim=1) & (worst >= bound)
        remaining = remaining & active[:, None]
    return best_t, best_n, windows


# ----------------------------------------------------------------------
# The XLA tile backend (kernel-free): candidate windows of units.

def candidate_window(scene: DeviceScene, apex: torch.Tensor,
                     normals: torch.Tensor, remaining: torch.Tensor,
                     kc: int):
    """Build one unit-level candidate window from the nearest remaining
    clusters of each tile.

    remaining: (tiles, C) bool — clusters hit by the tile frustum and not
    yet processed. Selects (up to) the kc nearest, refines their units
    with the tile's own frustum, and sorts the survivors front-to-back by
    the apex->AABB entry bound (a stable sort: equal keys keep unit
    order, as lax.sort_key_val does).

    Returns (cand (tiles, kc*UPC) int32, count (tiles,) int32, entry
    (tiles, kc*UPC) f32 ascending with +inf tail, new_remaining,
    next_bound (tiles,) f32 — the nearest entry bound of any tile's
    unselected cluster).
    """
    n_tiles = remaining.shape[0]
    cl_dist = culling.aabb_distance(apex, scene.cluster_aabb_min,
                                    scene.cluster_aabb_max)          # (C,)
    cidx, sel, _, new_remaining, next_bound = _select_nearest_clusters(
        cl_dist, remaining, kc)
    kc = cidx.shape[1]
    units = (cidx.to(torch.int64)[..., None] * UPC
             + torch.arange(UPC, device=cidx.device)[None, None]
             ).reshape(n_tiles, kc * UPC)
    umin = scene.unit_aabb_min[units]                     # (tiles, n, 3)
    umax = scene.unit_aabb_max[units]
    uhit = culling.frustum_hit_gathered(normals, apex, umin, umax)
    uhit &= scene.unit_valid[units]
    uhit &= torch.repeat_interleave(sel, UPC, dim=1)
    udist = culling.aabb_distance(apex, umin, umax)
    dkey = torch.where(uhit, udist, float("inf"))
    entry, order = torch.sort(dkey, dim=1, stable=True)
    cand = torch.gather(units, 1, order)
    count = uhit.sum(dim=1).to(torch.int32)
    return (cand.to(torch.int32), count, entry.to(torch.float32),
            new_remaining, next_bound)


def trace_windowed(scene: DeviceScene, fi: FrameInputs, cfg: RenderConfig,
                   trace_window: Callable, init_t: torch.Tensor, init_n):
    """Drive trace_window over candidate windows until every tile is done.

    trace_window(cand, count, entry, best_t, best_n) -> (best_t, best_n)
    folds one window's candidates into the running closest hit; best_t is
    (tiles, TILE) along-ray t (BIG = miss).

    A tile stays active while it has unprocessed clusters AND some ray
    could still improve: entry bounds are apex-relative, so a hit converts
    via t_apex = t + s, and a miss keeps the tile's worst at BIG (no early
    exit while any ray misses). One host sync per window. Returns
    (best_t, best_n, number of windows)."""
    kc = max(1, min(cfg.clusters_per_window, fi.cluster_hit.shape[1]))
    s_apex = fi.raymat[..., 6]                            # (tiles, TILE)
    active = fi.cluster_hit.any(dim=1)
    remaining = fi.cluster_hit & active[:, None]
    best_t, best_n = init_t, init_n
    windows = 0
    while spans.sync("tiled.candidate_window", active.any(), bool):
        cand, count, entry, remaining, bound = candidate_window(
            scene, fi.apex, fi.normals, remaining, kc)
        best_t, best_n = trace_window(cand, count, entry, best_t, best_n)
        windows += 1
        worst = torch.where(best_t < BIG, best_t + s_apex,
                            BIG).amax(dim=1)
        active = remaining.any(dim=1) & (worst >= bound)
        remaining = remaining & active[:, None]
    return best_t, best_n, windows


def candidate_counts(scene: DeviceScene, inv_view_proj,
                     cfg: RenderConfig) -> torch.Tensor:
    """(tiles,) exact per-tile unit-candidate counts (observability: the
    windows the trace would consume without early exit)."""
    fi = build_frame_inputs(scene, inv_view_proj, cfg)
    kc = max(1, min(cfg.clusters_per_window, fi.cluster_hit.shape[1]))
    remaining = fi.cluster_hit
    total = torch.zeros(remaining.shape[0], dtype=torch.int32,
                        device=remaining.device)
    while spans.sync("tiled.candidate_counts", remaining.any(), bool):
        _, count, _, remaining, _ = candidate_window(
            scene, fi.apex, fi.normals, remaining, kc)
        total = total + count
    return total


# Candidate slots prepared together: their tables gathered (or derived on
# a compressed scene), w columns and recentered rays built by one call
# each. Every step is elementwise per unit, so each slot gets the values a
# call of its own would give; the slots still fold one by one, in order.
SLOT_GROUP = 32


def candidate_group(scene: DeviceScene, q_frame, raymat: torch.Tensor,
                    units: torch.Tensor, apex=None):
    """The inputs of trace_candidate for G candidate slots of nt tiles.

    units: (G, nt) int, slot-major. Returns (rays (G, nt, TILE, 8) raymat
    recentered on each unit, q (G, nt, 8, 5*LPU) the unit's per-frame
    table (this frame's t_num in row 7 of the t block) followed by its w
    column block (det - u) - v, nrm (G, nt, LPU, 3)); compressed scenes
    (q_frame None) derive the tables from the units' records."""
    lpu = scene.leaves_per_unit
    shape = tuple(units.shape)
    flat = units.reshape(-1).to(torch.int64)
    centers = unit_centers(scene)[flat]                   # (n, 3)
    if scene.compressed:
        q, nrm = compressed.derive_q(scene.unit_grid[flat], apex, centers,
                                     corner_lanes(scene))
    else:
        q = q_frame[flat][..., :4 * lpu]                  # (n, 8, 4*LPU)
        nrm = scene.unit_nrm[flat]                        # (n, LPU, 3)
    q = torch.cat([q, (q[..., 0 * lpu:1 * lpu] - q[..., 1 * lpu:2 * lpu])
                   - q[..., 2 * lpu:3 * lpu]], dim=-1)
    rays = recentered_raymat(raymat, centers.reshape(shape + (3,)))
    return (rays, q.reshape(shape + q.shape[1:]),
            nrm.reshape(shape + nrm.shape[1:]))


def trace_candidate(scene: DeviceScene, rays: torch.Tensor,
                    q: torch.Tensor, nrm: torch.Tensor,
                    in_range: torch.Tensor, cfg: RenderConfig):
    """One candidate slot for a batch of tiles.

    rays, q, nrm: one slot of candidate_group's (nt tiles); in_range:
    (nt,) bool. Returns (t (nt, TILE), normal (nt, TILE, 3) unnormalised,
    summed over leaves that tie for the closest t).

    The Möller-Trumbore numerators are one batched float32 product of the
    recentered ray rows with the unit's table and w column, then the
    unguarded reciprocal, the w-form acceptance and the p-form t-window
    (p = t + s against [t_min + s, t_max + s], the upper side applied to
    the leaf minimum). cfg.debug_guards guards the reciprocal and restores
    the |det| >= MT_DET_EPS acceptance (the sanitizer render).
    """
    lpu = scene.leaves_per_unit
    out = torch.bmm(rays, q)                              # (nt, TILE, 5L)
    det = out[..., 0 * lpu:1 * lpu]
    if cfg.debug_guards:
        # The sanitizer render (utils/debug.py): a guarded division and the
        # reference's |det| >= EPS acceptance (intersection.hlsl:423), so
        # clean scenes stay NaN/Inf-free and only corrupt data fires.
        det_ok = torch.abs(det) >= intersect.MT_DET_EPS
        inv = _f32.rdiv(1.0, torch.where(det_ok, det, 1.0))
    else:
        inv = _f32.rdiv(1.0, det)
    u = out[..., 1 * lpu:2 * lpu] * inv
    v = out[..., 2 * lpu:3 * lpu] * inv
    ww = out[..., 4 * lpu:5 * lpu] * inv
    s = rays[..., 6:7]
    p = out[..., 3 * lpu:4 * lpu] * inv
    ok = ((torch.minimum(torch.minimum(u, v), ww) >= -intersect.MT_UV_EPS)
          & (p >= cfg.t_min + s) & in_range[:, None, None])
    if cfg.debug_guards:
        ok &= det_ok
    p = torch.where(ok, p, BIG)
    pb = p.amin(dim=2)                                    # (nt, TILE)
    tb = torch.where(pb <= cfg.t_max + s[..., 0], pb - s[..., 0], BIG)
    # Ties sum (normalised again before shading); invalid leaves hold p ==
    # BIG and match only on all-miss lanes, whose tb == BIG never wins.
    onehot = (p <= pb[..., None]).to(torch.float32)
    nb = torch.bmm(onehot, nrm)                           # (nt, TILE, 3)
    return tb, nb


@functools.lru_cache(maxsize=None)
def _uniform_corners(su: int, device: str) -> torch.Tensor:
    return torch.from_numpy(compressed.uniform_unit_indices(su)).to(device)


def corner_lanes(scene: DeviceScene):
    """(3, LPU) int32 corner lanes shared by every record of a compressed
    scene (its one topology's gather matrix, or the all-present one), or
    None when each indexed record carries its own (rows 3-5)."""
    if scene.unit_gmat is not None:
        return compressed.corner_lanes(scene.unit_gmat)
    if scene.indexed:
        return None
    return _uniform_corners(scene.sub_level, str(scene.device))


def xla_trace_frame(scene: DeviceScene, fi: FrameInputs,
                    cfg: RenderConfig, check: Callable | None = None):
    """Trace one frame's primary rays with the XLA-backend windows.

    Tiles go in chunks of cfg.tile_chunk; a window's candidate slots run
    up to the chunk's largest count (the slots past every tile's count
    fold nothing, so stopping there is exact). Returns (best_t (tiles,
    TILE) with BIG = miss, best_n (tiles, TILE, 3) unnormalised).

    check(stage, tensor, bound=None), when given (the sanitizer render,
    utils/debug.py), sees each window's candidate units (bound: the unit
    count) and its running t and normals."""
    n_tiles = fi.raymat.shape[0]
    tile_chunk = max(1, min(n_tiles, cfg.tile_chunk))
    if n_tiles % tile_chunk:
        tile_chunk = n_tiles
    window = 0

    def trace_window(cand, count, entry, best_t, best_n):
        nonlocal window
        window += 1
        if check is not None:
            check(f"window {window}: candidate units", cand,
                  scene.num_units)
        bt_out, bn_out = [], []
        for c0 in range(0, n_tiles, tile_chunk):
            sl = slice(c0, c0 + tile_chunk)
            rm, cnd, cnt = fi.raymat[sl], cand[sl], count[sl]
            bt, bn = best_t[sl], best_n[sl]
            n_slots = min(cand.shape[1],
                          spans.sync("tiled.slots", cnt.max()))
            for g0 in range(0, n_slots, SLOT_GROUP):
                g1 = min(g0 + SLOT_GROUP, n_slots)
                rays, q, nrm = candidate_group(scene, fi.q_frame, rm,
                                               cnd[:, g0:g1].T, fi.apex)
                for j in range(g1 - g0):
                    tb, nb = trace_candidate(scene, rays[j], q[j], nrm[j],
                                             g0 + j < cnt, cfg)
                    take = tb < bt
                    bt = torch.where(take, tb, bt)
                    bn = torch.where(take[..., None], nb, bn)
            bt_out.append(bt)
            bn_out.append(bn)
        best_t, best_n = torch.cat(bt_out), torch.cat(bn_out)
        if check is not None:
            check(f"window {window}: t", best_t)
            check(f"window {window}: normals", best_n)
        return best_t, best_n

    dev = fi.raymat.device
    init_t = torch.full((n_tiles, TILE), BIG, dtype=torch.float32,
                        device=dev)
    init_n = torch.zeros((n_tiles, TILE, 3), dtype=torch.float32,
                         device=dev)
    best_t, best_n, _ = trace_windowed(scene, fi, cfg, trace_window, init_t,
                                       init_n)
    return best_t, best_n


def render_tiled(scene: DeviceScene, inv_view_proj,
                 cfg: RenderConfig, check: Callable | None = None
                 ) -> torch.Tensor:
    """Render one frame through the XLA tile backend (the CLI's
    --pipeline tile). Returns (H, W, 3) float32 on the scene's device.
    check: as xla_trace_frame's; it also sees the prologue's ray matrix,
    frusta and per-frame table."""
    width, height = cfg.width, cfg.height
    pw, ph = padded_size(width, height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    fi = build_frame_inputs(scene, inv_view_proj, cfg, need_q_frame=True)
    if check is not None:
        for name in ("raymat", "apex", "normals", "sub_normals",
                     "scene_aabb", "q_frame"):
            if getattr(fi, name) is not None:
                check(f"prologue: {name}", getattr(fi, name))
    best_t, best_n = xla_trace_frame(scene, fi, cfg, check)
    hit = best_t < BIG
    nrm = best_n / torch.clamp_min(culling._norm(best_n, keepdim=True),
                                   1e-20)
    colors = shading.shade_or_miss(hit, nrm, -fi.dirs, cfg)
    img = (colors.reshape(ty, tx, culling.TILE_H, culling.TILE_W, 3)
           .permute(0, 2, 1, 3, 4).reshape(ph, pw, 3))
    return img[:height, :width]
