"""The frame prologue's two kernels: the tile frusta (tile_frusta) and the
cluster cull + front-to-back select (cluster_select), which build the
trace kernel's per-tile cluster lists on every K1 path.

On the TPU this is XLA-fused device code, no Pallas kernel behind it,
inside the JAX package's jitted prologue (render_pallas_frames'
jax.vmap(frame_inputs), rtmm_tpu/ops/pallas_tiled.py:1490-1509); here it
is two hand-written kernels, csrc/prologue.cu.

  tile_frusta / tile_frusta_plain
      per frame the apex, per tile its 4 cone planes and its n_sub
      sub-cones' planes (culling.tile_frustums, tile_sub_frustums), over
      a range of tiles, and optionally the trace kernel's scalar pack
      (tiled.frustum_scalars, with or without the raygen scalars).
  cluster_select / cluster_select_plain
      per row (a (frame, tile) or an (instance, tile)), every cluster
      culled against the row's planes (culling.cull_units) or read from
      a `remaining` mask, and the kc nearest in (apex distance, cluster
      index) order (culling.aabb_distance,
      tiled._select_nearest_clusters): the lists, their count, the entry
      distances; optionally the hit mask and the row's any-hit, and the
      window's cleared mask and next bound.
  LAUNCHES  kernel launches so far (a view of the counters in
            utils/spans.py).

The wrappers take the kernel for CUDA tensors (building it on first use;
a failed build or launch raises) and the plain version for CPU tensors.
The plain versions compose the port's culling and tiled functions; the
kernels do the same float32 operations in the same order, so the two
agree bit for bit on the card.

A list's (distance, index) keys depend on the row's apex only, so the
kernel orders each apex's clusters once and every row of that apex takes
its held clusters in that order (rows with an apex of their own, as the
merged instanced rows, order per row); past select_capacity() clusters
it selects per row instead (csrc/prologue.cu).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import spans
from . import culling

KERNELS = ("tile_frusta", "cluster_select")
LAUNCHES = spans.LaunchView(KERNELS)
PACKS = (None, "plain", "raygen")


def reset_launches() -> None:
    LAUNCHES.reset()


class Frusta(NamedTuple):
    """tile_frusta's outputs; leading frame axes as inv_view_proj's."""

    apex: torch.Tensor          # (..., 3)
    normals: torch.Tensor       # (..., tiles, 4, 3)
    sub_normals: torch.Tensor   # (..., tiles, n_sub, 4, 3); with a
                                # pack, a view of the pack's planes
    frus: torch.Tensor | None   # (..., tiles, pack)


class Selection(NamedTuple):
    """cluster_select's outputs, one row each; None where not asked."""

    ccand: torch.Tensor | None          # (rows, kc) int32
    ccount: torch.Tensor | None         # (rows,) int32
    centry: torch.Tensor | None         # (rows, kc) f32, +inf tail
    hit: torch.Tensor | None            # (rows, C) bool
    any: torch.Tensor | None            # (rows,) bool
    new_remaining: torch.Tensor | None  # (rows, C) bool
    next_bound: torch.Tensor | None     # (rows,) f32


def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tile_range(pw: int, ph: int, tiles):
    n_all = (pw // culling.TILE_W) * (ph // culling.TILE_H)
    tile0, n_tiles = (0, n_all) if tiles is None else tiles
    if not (0 <= tile0 and 0 <= n_tiles and tile0 + n_tiles <= n_all):
        raise ValueError(f"tile range {tiles} outside the {n_all} tiles")
    return tile0, n_tiles, n_all


# ----------------------------------------------------------------------
# Plain PyTorch versions.

def tile_frusta_plain(inv_view_proj, width: int, height: int, pw: int,
                      ph: int, n_sub: int, n_rows: int, *, tiles=None,
                      pack=None, scene_aabb=None) -> Frusta:
    """Plain version of tile_frusta (same arguments and returns)."""
    from . import tiled
    m = torch.as_tensor(inv_view_proj, dtype=torch.float32)
    tile0, n_tiles, _ = _tile_range(pw, ph, tiles)
    apex, normals = culling.tile_frustums(m, width, height, pw, ph,
                                          device=m.device)
    sub = culling.tile_sub_frustums(m, width, height, pw, ph, n_sub=n_sub,
                                    n_rows=n_rows, device=m.device)
    normals = normals.narrow(-3, tile0, n_tiles)
    sub = sub.narrow(-4, tile0, n_tiles)
    frus = None
    if pack is not None:
        fi = tiled.FrameInputs(None, None, apex, normals, None, sub,
                               scene_aabb)
        frus = tiled.frustum_scalars(
            fi, raygen_ivp=m if pack == "raygen" else None,
            tx=pw // culling.TILE_W)
        sub = _pack_planes(frus, n_sub)
    return Frusta(apex, normals, sub, frus)


def _pack_planes(frus, n_sub: int):
    """The sub-cone planes inside a frustum pack, as a view."""
    return frus[..., 3:3 + 12 * n_sub].unflatten(-1, (n_sub, 4, 3))


def cluster_select_plain(apex, planes, aabb_min, aabb_max, valid, kc: int,
                         *, remaining=None, row_valid=None,
                         rows_per_apex: int = 1, want_hit: bool = False,
                         want_any: bool = False,
                         window: bool = False) -> Selection:
    """Plain version of cluster_select (same arguments and returns)."""
    from . import tiled
    n_apex = apex.shape[0]
    n_cl = aabb_min.shape[0]
    if remaining is None:
        hit = culling.cull_units(
            apex, planes.reshape(n_apex, rows_per_apex, 4, 3), aabb_min,
            aabb_max, valid).reshape(-1, n_cl)
    else:
        hit = remaining
    if row_valid is not None:
        hit = hit & row_valid[:, None]
    out = dict.fromkeys(Selection._fields)
    if want_hit:
        out["hit"] = hit
    if want_any:
        out["any"] = hit.any(dim=1)
    if kc:
        cl_dist = culling.aabb_distance(apex[:, None, :], aabb_min,
                                        aabb_max)                # (A, C)
        cidx, sel, skey, new_rem, bound = tiled._select_nearest_clusters(
            cl_dist[:, None, :], hit.reshape(n_apex, rows_per_apex, n_cl),
            kc)
        k = cidx.shape[-1]
        out.update(ccand=cidx.reshape(-1, k).contiguous(),
                   ccount=sel.sum(dim=-1).to(torch.int32).reshape(-1),
                   centry=skey.reshape(-1, k).contiguous())
        if window:
            out.update(new_remaining=new_rem.reshape(-1, n_cl),
                       next_bound=bound.reshape(-1))
    return Selection(**out)


# ----------------------------------------------------------------------
# Kernel wrappers.

@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build
    lib = _build.load("prologue")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    frusta = lib.rtmm_tile_frusta
    frusta.argtypes = ([vp, ci] + [cf] * 4 + [ci] * 5 + [vp, ci, ci]
                       + [vp] * 5)
    frusta.restype = ci
    select = lib.rtmm_cluster_select
    select.argtypes = [ci] * 3 + [vp, ci] + [vp] * 14
    select.restype = ci
    err = lib.rtmm_prologue_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    lib.rtmm_prologue_select_cap.restype = ci
    return frusta, select, err, lib.rtmm_prologue_select_cap


def select_capacity() -> int:
    """The most clusters cluster_select orders in shared memory, once
    per apex; past it, each row selects its own (builds the kernel)."""
    return _lib()[3]()


def _raise(rc: int, name: str, err) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + err(rc).decode())


def _ptr(x):
    return None if x is None else x.data_ptr()


def _device(dev, **tensors):
    for name, x in tensors.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the prologue kernels run on cuda or cpu, not "
                         f"{dev}")


def tile_frusta(inv_view_proj, width: int, height: int, pw: int, ph: int,
                n_sub: int, n_rows: int, *, tiles=None, pack=None,
                scene_aabb=None) -> Frusta:
    """The tile frusta of F frames (inv_view_proj (F, 4, 4) float32, or
    one (4, 4)): width / height map the NDC, pw / ph (multiples of the
    tile) set the tile grid; n_sub sub-cones per tile in n_rows rows.
    tiles = (first, count) builds that range of the flat tile index only
    (a rank's share of a sharded frame).

    Returns Frusta(apex (F, 3), normals (F, tiles, 4, 3), sub_normals (F,
    tiles, n_sub, 4, 3), frus): each value culling.tile_frustums' and
    tile_sub_frustums' at those tiles. pack "plain" or "raygen" also
    builds the trace kernel's per-tile scalar pack (tiled.frustum_scalars
    without or with the raygen scalars; "raygen" over the whole frame
    only), with scene_aabb (6,) its scene box; frus is None without.
    With a pack the sub-cone planes are written once, into the pack, and
    sub_normals is a view of them.
    CUDA tensors launch tile_frusta (csrc/prologue.cu); CPU tensors run
    tile_frusta_plain."""
    with spans.span("rtmm.prologue.tile_frusta"):
        if pack not in PACKS:
            raise ValueError(f"pack must be one of {PACKS}, not {pack!r}")
        if n_sub % n_rows or culling.TILE_H % n_rows or (
                culling.TILE_W % (n_sub // n_rows)) or not 0 < n_sub <= 8:
            raise ValueError(f"unsupported sub-cone grid {n_sub}/{n_rows}")
        if pw % culling.TILE_W or ph % culling.TILE_H:
            raise ValueError(f"padded size {pw}x{ph} is not a tile multiple")
        m = torch.as_tensor(inv_view_proj, dtype=torch.float32)
        if tuple(m.shape[-2:]) != (4, 4) or m.dim() not in (2, 3):
            raise ValueError(f"inv_view_proj must be (4, 4) or (F, 4, 4), not "
                             f"{tuple(m.shape)}")
        tile0, n_tiles, n_all = _tile_range(pw, ph, tiles)
        if pack == "raygen" and n_tiles != n_all:
            raise ValueError("the raygen pack is built for whole frames")
        if pack is not None:
            if scene_aabb is None:
                raise ValueError("a pack needs the scene box")
            _device(m.device, scene_aabb=scene_aabb)
            _check("scene_aabb", scene_aabb, torch.float32, (6,))
        _device(m.device)
        if m.device.type == "cpu":
            return tile_frusta_plain(m, width, height, pw, ph, n_sub, n_rows,
                                     tiles=tiles, pack=pack,
                                     scene_aabb=scene_aabb)
        from . import tiled
        lead = m.shape[:-2]
        mf = m.reshape(-1, 16).contiguous()
        n_frames = mf.shape[0]
        dev = m.device

        def empty(*shape):
            return torch.empty((*lead, *shape), dtype=torch.float32,
                               device=dev)

        apex = empty(3)
        normals = empty(n_tiles, 4, 3)
        sub, frus, pack_len = None, None, 0
        if pack is None:
            sub = empty(n_tiles, n_sub, 4, 3)
        else:
            pack_len = tiled.frustum_pack_len(n_sub, pack == "raygen")
            frus = empty(n_tiles, pack_len)
        fn, _, err, _ = _lib()
        with torch.cuda.device(dev):
            rc = fn(mf.data_ptr(), n_frames, float(width), float(height),
                    float(pw), float(ph), pw // culling.TILE_W, tile0, n_tiles,
                    n_sub, n_rows, _ptr(scene_aabb), pack_len,
                    int(pack == "raygen"), apex.data_ptr(), normals.data_ptr(),
                    _ptr(sub), _ptr(frus),
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise(rc, "tile_frusta", err)
        spans.launch("tile_frusta")
        if frus is not None:
            sub = _pack_planes(frus, n_sub)
        return Frusta(apex, normals, sub, frus)


def cluster_select(apex, planes, aabb_min, aabb_max, valid, kc: int, *,
                   remaining=None, row_valid=None, rows_per_apex: int = 1,
                   want_hit: bool = False, want_any: bool = False,
                   window: bool = False) -> Selection:
    """The coarse cull and the front-to-back cluster lists of R rows.

    apex (A, 3) float32, one per rows_per_apex consecutive rows (A x
    rows_per_apex = R); planes (R, 4, 3) the rows' tile planes, culled
    against the cluster boxes aabb_min / aabb_max (C, 3) and valid (C,)
    bool as culling.cull_units culls, or remaining (R, C) bool the
    clusters each row still holds (planes and valid then unused, may be
    None);
    row_valid (R,) bool clears whole rows.

    kc > 0: per row the min(kc, C) nearest of its clusters in (apex
    distance, cluster index) order, as tiled._select_nearest_clusters
    (and jax.lax.top_k) give them: ccand (R, kc) int32 (past the count,
    the next clusters in that order, the row's others by index), ccount
    (R,) int32, centry (R, kc) float32 with a +inf tail. window also
    gives new_remaining (R, C) bool, the clusters strictly after the
    kc-th selected pair (none when fewer were selected), and next_bound
    (R,) their nearest distance (+inf when none). want_hit / want_any
    give the rows' cluster mask (R, C) and its any (R,). kc = 0 culls
    only. CUDA tensors launch cluster_select (csrc/prologue.cu); CPU
    tensors run cluster_select_plain."""
    with spans.span("rtmm.prologue.cluster_select"):
        dev = apex.device
        _device(dev, planes=planes, aabb_min=aabb_min, aabb_max=aabb_max,
                valid=valid, remaining=remaining, row_valid=row_valid)
        if remaining is None and (planes is None or valid is None):
            raise ValueError("cluster_select needs planes and valid, or "
                             "remaining")
        n_apex = apex.shape[0]
        n_rows = n_apex * rows_per_apex
        n_cl = aabb_min.shape[0]
        kc = min(kc, n_cl)
        if window and not kc:
            raise ValueError("the window form needs kc > 0")
        apex, planes, remaining, row_valid = (
            None if x is None else x.contiguous()
            for x in (apex, planes, remaining, row_valid))
        if planes is not None and planes.data_ptr() % 16:
            planes = planes.clone()  # the kernel reads a row as 3 float4
        _check("apex", apex, torch.float32, (n_apex, 3))
        if planes is not None:
            _check("planes", planes, torch.float32, (n_rows, 4, 3))
        if remaining is not None:
            _check("remaining", remaining, torch.bool, (n_rows, n_cl))
        if row_valid is not None:
            _check("row_valid", row_valid, torch.bool, (n_rows,))
        _check("aabb_min", aabb_min, torch.float32, (n_cl, 3))
        _check("aabb_max", aabb_max, torch.float32, (n_cl, 3))
        if valid is not None:
            _check("valid", valid, torch.bool, (n_cl,))
        if dev.type == "cpu":
            return cluster_select_plain(
                apex, planes, aabb_min, aabb_max, valid, kc,
                remaining=remaining, row_valid=row_valid,
                rows_per_apex=rows_per_apex, want_hit=want_hit,
                want_any=want_any, window=window)

        def empty(shape, dtype, on=True):
            return torch.empty(shape, dtype=dtype, device=dev) if on else None

        hit = empty((n_rows, n_cl), torch.bool, want_hit)
        any_ = empty((n_rows,), torch.bool, want_any)
        ccand = empty((n_rows, kc), torch.int32, kc > 0)
        ccount = empty((n_rows,), torch.int32, kc > 0)
        centry = empty((n_rows, kc), torch.float32, kc > 0)
        new_rem = empty((n_rows, n_cl), torch.bool, window)
        bound = empty((n_rows,), torch.float32, window)
        _, fn, err, _ = _lib()
        with torch.cuda.device(dev):
            rc = fn(n_rows, n_cl, kc, apex.data_ptr(), rows_per_apex,
                    _ptr(planes), _ptr(remaining), _ptr(row_valid),
                    aabb_min.data_ptr(), aabb_max.data_ptr(), _ptr(valid),
                    _ptr(hit), _ptr(any_), _ptr(ccand), _ptr(ccount),
                    _ptr(centry), _ptr(new_rem), _ptr(bound),
                    torch.cuda.current_stream(dev).cuda_stream)
        _raise(rc, "cluster_select", err)
        spans.launch("cluster_select")
        return Selection(ccand, ccount, centry, hit, any_, new_rem, bound)
