"""Tile trace: the port of the JAX package's Pallas trace kernel
(rtmm_tpu/ops/pallas_tiled.py::trace_pallas; body _kernel ->
_trace_tile_nonempty) in its fused, windowed, raw and compressed modes.

For each 32x32 ray tile the kernel takes the tile's rays (generated
in-kernel, or rows of a ray matrix), walks the tile's front-to-back
cluster list, culls each cluster's 64 units against the tile's sub-cones
and per-sub worst-hit bounds, visits the two nearest eligible units per
step (recentered-moment Möller-Trumbore over the unit's 64 leaves,
strict-< running best), and stops when no remaining cluster can beat the
tile's worst hit. A unit's tables are read from the precomputed unit_qn
rows, or, in a compressed scene, derived from its grid-vertex record.

  trace_fused            fused mode (K1a, K1c): one launch traces and
                         shades whole frames.
  trace_windowed         windowed mode (K1b, K1c): one cluster window of a
                         longer walk, the running best carried in and out.
  trace_raw              raw mode (K1d, K1c; trace_pallas(raw=True), with
                         xform_raygen=True when no ray matrix is given):
                         every row starts fresh and comes back as one
                         compact [t, nx, ny, nz] row, unshaded. Without a
                         ray matrix the kernel generates the world rays and
                         takes them into the row's object space, so one
                         launch traces the tile rows of every instance of a
                         two-level scene (render/instances.py). Like the
                         other modes it is bound by arithmetic; its output,
                         16 KB per row, is its largest stream.
  trace_fused_plain,     the same walks in plain PyTorch (a Python loop
  trace_windowed_plain,  over tiles, clusters and picks; each unit visit
  trace_raw_plain        vectorised over 64 leaves x 1,024 rays), operation
                         for operation the kernel's arithmetic.
  LAUNCHES               kernel launches so far, per kernel entry.
  render_frame           one frame (render_pallas): fused when every
                         tile's cluster list fits one launch, else windowed.
  render_frames          F frames (render_pallas_frames).

The wrappers launch the CUDA kernel (csrc/tile_trace.cu) on CUDA tensors
and run the plain version on CPU tensors.

Semantics kept from the TPU kernel: the w-form acceptance
min(u, v, w) >= -MT_UV_EPS with no det guard, the p-form t-window (p = t +
s against [t_min + s, t_max + s], the upper side applied to the leaf
minimum), the tie-summed winner normal, the strict-< fold, pick-2 on
integer (distance | lane) keys, and the visit/eligible counters.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from . import _f32, compressed, culling, shading, tiled
from .intersect import MT_UV_EPS

BIG = 1e30
IMAX = 0x7FFFFFFF
TILE = culling.TILE_H * culling.TILE_W
UPC = culling.UNITS_PER_CLUSTER
LPU = 64
MAX_SUB = 8
# The ray rows [d, m'] that the det column sums over: its moment rows are
# zero by construction ([-n] over d, [0] over m'), and the kernel sums only
# the first three, left to right. Dropping a +-0 * x term changes a sum
# only where the partial sum is exactly +-0 (-0 + +0 is +0, and the sign of
# det sets the sign of 1/det) or x is inf or NaN; both versions drop the
# same terms (tests/test_torch_k1_terms.py holds them to all six rows).
DET_ROWS = 3
# Tile rows per launch in render_frames: 32 frames of 1080p (2,040 tiles
# each) fit in one launch; the rgb output is then ~0.8 GB of float32.
BATCH_TILE_CAP = 65536

# Kernel launches so far, by entry: fused, windowed or raw, precomputed or
# compressed tables.
KERNELS = ("tile_trace_fused", "tile_trace_fused_compressed",
           "tile_trace_windowed", "tile_trace_windowed_compressed",
           "tile_trace_raw", "tile_trace_raw_compressed")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Shading constants, float32-rounded exactly where shade_rows rounds them.

def shade_params(cfg: RenderConfig) -> np.ndarray:
    """The kernel's float parameter block (layout of `Params` in
    csrc/tile_trace.cu): each value is the Python double expression of
    shading.shade_rows rounded once to float32, where it meets a row."""
    pi = shading.PI
    alb = [float(c) for c in cfg.mesh_color]
    f0 = [0.04 + (a - 0.04) * cfg.metallic for a in alb]
    r = cfg.roughness + 1.0
    k = (r * r) / 8.0
    a2 = (cfg.roughness * cfg.roughness) ** 2
    vals = [float(cfg.width), float(cfg.height), cfg.t_min, cfg.t_max]
    vals += list(cfg.background)
    vals += alb
    vals += f0
    vals += [1.0 - f for f in f0]
    vals += [a / pi for a in alb]
    vals += [a * (cfg.ambient_occlusion * cfg.light_intensity * 0.1)
             for a in alb]
    for lscale in shading.LIGHT_SCALE:
        vals += [cfg.light_color[c] * cfg.light_intensity * lscale
                 for c in range(3)]
    vals += [1.0 - cfg.metallic, 1.0 - k, k, a2 - 1.0, a2, pi,
             cfg.shading_weight]
    return np.asarray(vals, np.float32)


# ----------------------------------------------------------------------
# Scene tables.

def scene_tables(scene: DeviceScene):
    """(meta, tables, options) of the trace wrappers for a scene: the
    per-cluster unit metadata, then unit_qn, or the compressed records
    with their corner lanes (shared by every unit, or None when each
    indexed record carries its own)."""
    if not scene.compressed:
        return scene.cluster_unit_meta, scene.unit_qn, {}
    return (scene.cluster_unit_meta, scene.unit_grid,
            {"compressed": True, "corners": tiled.corner_lanes(scene)})


# ----------------------------------------------------------------------
# Plain PyTorch version.

def _worst_subs(bt, s, exit_t, smask):
    """Per-sub-tile worst-case reach (floored at 0): a ray contributes its
    hit's apex-relative t, or — while it still misses — its scene-AABB
    exit t."""
    v = torch.where(bt < BIG, bt + s, exit_t)
    return torch.stack([torch.where(m, v, 0.0).amax() for m in smask])


def _raygen(fr, nsub, cfg, col_f, row_f, xform=False):
    """In-kernel raygen (pallas_tiled._raygen_rows): true divisions.
    Returns the ray rows (d xyz, m = a x d xyz, s). xform: the pack
    carries [R^T (9), inv_s, apex_w (3)] after the scene box; s is taken
    against apex_w, then d_o = R^T d_w (3-term sums left to right), s
    scales by inv_s, and the moments are about the object-space apex at
    the pack head."""
    rg = 3 + nsub * 12

    def m(i, j):
        return fr[rg + 2 + 4 * i + j]

    u = _f32.div(fr[rg] + col_f + 0.5, float(cfg.width))
    v = _f32.div(fr[rg + 1] + row_f + 0.5, float(cfg.height))
    ndc_x = u * 2.0 - 1.0
    ndc_y = -(v * 2.0 - 1.0)
    pn = [m(i, 0) * ndc_x + m(i, 1) * ndc_y + m(i, 3) for i in range(4)]
    pf = [m(i, 0) * ndc_x + m(i, 1) * ndc_y + (m(i, 2) + m(i, 3))
          for i in range(4)]
    ox, oy, oz = pn[0] / pn[3], pn[1] / pn[3], pn[2] / pn[3]
    dx = pf[0] / pf[3] - ox
    dy = pf[1] / pf[3] - oy
    dz = pf[2] / pf[3] - oz
    ln = torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / ln, dy / ln, dz / ln
    ax, ay, az = fr[0], fr[1], fr[2]
    if xform:
        xf = fr[rg + 18 + 6:]
        s = (ox - xf[10]) * dx + (oy - xf[11]) * dy + (oz - xf[12]) * dz
        dx, dy, dz = (xf[0] * dx + xf[1] * dy + xf[2] * dz,
                      xf[3] * dx + xf[4] * dy + xf[5] * dz,
                      xf[6] * dx + xf[7] * dy + xf[8] * dz)
        s = s * xf[9]
    else:
        s = (ox - ax) * dx + (oy - ay) * dy + (oz - az) * dz
    return (dx, dy, dz, ay * dz - az * dy, az * dx - ax * dz,
            ax * dy - ay * dx, s)


def _cluster_tables(tables, compressed_, corners, cl, crow, apex):
    """The plain walk's unit tables of cluster cl: a function of the unit
    lane u -> (qd, qu, qv (6, LPU), t_num (LPU,), nrm (3, LPU)), read from
    unit_qn rows, or derived for all 64 compressed records at once
    (elementwise, so each unit gets the values the kernel derives for it
    alone)."""
    if compressed_:
        q, tn, nrm = compressed.derive_unit_tables(
            tables[cl * UPC:(cl + 1) * UPC], apex, crow[:, :UPC].T, corners)
        return lambda u: (q[u, :, 0:LPU], q[u, :, LPU:2 * LPU],
                          q[u, :, 2 * LPU:3 * LPU], tn[u], nrm[u].T)
    ax, ay, az = apex[0], apex[1], apex[2]

    def unit(u):
        q = tables[cl * UPC + u]                        # (8, 4*LPU + 128)
        qd = q[0:6, 0:LPU]
        nrm = q[0:4, 4 * LPU:5 * LPU]
        cx, cy, cz = crow[0, u], crow[1, u], crow[2, u]
        s_neg = (ax - cx) * qd[0] + (ay - cy) * qd[1] + (az - cz) * qd[2]
        return (qd, q[0:6, LPU:2 * LPU], q[0:6, 2 * LPU:3 * LPU],
                -s_neg - nrm[3], nrm[0:3])
    return unit


def _trace_tile_plain(fr, rays, raygen, ccand_row, centry_row, cnt, meta,
                      tables, cfg, nsub, smask, lane, carry):
    """One tile's walk. rays: (dx, dy, dz, mx, my, mz, s) rows of TILE
    rays, generated from the pack's raygen scalars when raygen; tables:
    (cl, crow) -> the cluster's unit tables (_cluster_tables); carry: the
    running best (bt, [bnx, bny, bnz], visits, eligible) it starts from.
    Returns the carry after the walk."""
    dx, dy, dz, mx, my, mz, s = rays
    ax, ay, az = fr[0], fr[1], fr[2]
    # Per-ray scene-exit reach through the inflated scene AABB, which
    # follows the raygen scalars when the pack has them.
    sb = 3 + nsub * 12 + (18 if raygen else 0)
    exit_t = None
    for k, (dk, ak) in enumerate(((dx, ax), (dy, ay), (dz, az))):
        safe = torch.where(torch.abs(dk) < 1e-12,
                           torch.where(dk >= 0.0, 1e-12, -1e-12), dk)
        inv = _f32.rdiv(1.0, safe)
        ek = torch.maximum((fr[sb + k] - ak) * inv,
                           (fr[sb + 3 + k] - ak) * inv)
        exit_t = ek if exit_t is None else torch.minimum(exit_t, ek)
    pmin = cfg.t_min + s
    pmax = cfg.t_max + s
    bt, bn, nv, ne = carry

    def process(unit, u, crow):
        """One unit visit: fold its 64 leaves into the running best."""
        nonlocal bt, bn
        qd, qu, qv, tn, nrm = unit(u)
        qw = (qd - qu) - qv                             # w on the q columns
        cx, cy, cz = crow[0, u], crow[1, u], crow[2, u]
        # Recentered moment m' = (a - c) x d = m - c x d.
        rows = (dx, dy, dz,
                mx - (cy * dz - cz * dy),
                my - (cz * dx - cx * dz),
                mz - (cx * dy - cy * dx))

        def contract(qb, n_rows=6):
            acc = qb[0][:, None] * rows[0][None, :]
            for r in range(1, n_rows):
                acc = acc + qb[r][:, None] * rows[r][None, :]
            return acc                                  # (LPU, TILE)

        det = contract(qd, DET_ROWS)
        iv = _f32.rdiv(1.0, det)
        uu = contract(qu) * iv
        vv = contract(qv) * iv
        ww = contract(qw) * iv
        pp = tn[:, None] * iv
        muv = torch.minimum(torch.minimum(uu, vv), ww)
        ok = (muv >= -MT_UV_EPS) & (pp >= pmin[None, :])
        p = torch.where(ok, pp, BIG)
        pb = p.amin(dim=0)
        tb = torch.where(pb <= pmax, pb - s, BIG)
        win = p <= pb[None, :]
        nsel = [torch.where(win, nrm[c][:, None], 0.0).sum(dim=0)
                for c in range(3)]
        take = tb < bt
        bt = torch.where(take, tb, bt)
        bn = [torch.where(take, nsel[c], bn[c]) for c in range(3)]

    ws = _worst_subs(bt, s, exit_t, smask)
    ci = 0
    kc = centry_row.shape[0]
    while ci < cnt and float(ws.max()) >= float(centry_row[min(ci, kc - 1)]):
        cl = int(ccand_row[ci])
        mt = meta[cl]                                   # (8, 128)
        mnx, mny, mnz = mt[0], mt[1], mt[2]
        mxx, mxy, mxz = mt[3], mt[4], mt[5]
        crow = 0.5 * (mt[0:3] + mt[3:6])
        unit = tables(cl, crow)
        valid = mt[6] > 0.0
        insides = []
        for j in range(nsub):
            inside = valid
            for pl in range(4):
                base = 3 + 12 * j + 3 * pl
                nx, ny, nz = fr[base], fr[base + 1], fr[base + 2]
                dot = (nx * ((mxx if float(nx) >= 0.0 else mnx) - ax)
                       + ny * ((mxy if float(ny) >= 0.0 else mny) - ay)
                       + nz * ((mxz if float(nz) >= 0.0 else mnz) - az))
                inside = inside & (dot >= 0.0)
            insides.append(inside)
        ddx = torch.clamp_min(torch.maximum(mnx - ax, ax - mxx), 0.0)
        ddy = torch.clamp_min(torch.maximum(mny - ay, ay - mxy), 0.0)
        ddz = torch.clamp_min(torch.maximum(mnz - az, az - mxz), 0.0)
        dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)  # (128,)
        # Integer keys: distance bits (monotone for dist >= 0) with the
        # lane in the low 7 bits; one min picks the nearest unit and its
        # lane. IMAX = removed or ineligible.
        dkey = torch.bitwise_or(
            torch.bitwise_and(dist.view(torch.int32), -128), lane)

        def keys(wsv, removed):
            elig = insides[0] & (dist <= wsv[0])
            for j in range(1, nsub):
                elig = elig | (insides[j] & (dist <= wsv[j]))
            return torch.where(elig & ~removed, dkey, IMAX)

        def pick2(ikey):
            ikey = ikey.clone()
            picks = []
            for _ in range(2):
                p = int(ikey.min())
                u = (p & 127) if p < IMAX else 128
                if u < 128:
                    ikey[u] = IMAX
                picks.append(u)
            return picks[0], picks[1], ikey

        ua, ub, ikey = pick2(keys(ws, torch.zeros_like(valid)))
        while ua < 128:
            hasb = ub < 128
            process(unit, ua, crow)
            if hasb:
                # (The TPU kernel recomputes unit A in a slot with no B:
                # an idempotent fold, skipped here.)
                process(unit, ub, crow)
            ws = _worst_subs(bt, s, exit_t, smask)
            removed = ikey >= IMAX
            ua, ub, ikey = pick2(torch.where(removed, IMAX,
                                             keys(ws, removed)))
            nv += 1 + int(hasb)
            ne += 1 + int(hasb)
        ci += 1
    return bt, bn, nv, ne


def _sub_masks(nsub: int, nrows: int, device) -> list[torch.Tensor]:
    """Ray masks of the sub-cone grid: pixel (r, c) of the tile is ray
    r*TILE_W + c; sub j = row * ncols + col."""
    idx = torch.arange(TILE, device=device)
    col = idx % culling.TILE_W
    row = idx // culling.TILE_W
    ncols = nsub // nrows
    sw = culling.TILE_W // ncols
    sh = culling.TILE_H // nrows
    return [((row >= (j // ncols) * sh) & (row < (j // ncols + 1) * sh)
             & (col >= (j % ncols) * sw) & (col < (j % ncols + 1) * sw))
            for j in range(nsub)]


def _plain_walks(ccand, ccount, centry, frus, raymat, meta, tables, cfg,
                 carry, compressed_=False, corners=None, rows=None,
                 xform=False):
    """Walk every non-empty tile row of frus (or of `rows`), yielding
    (row, rays, carry after the walk); carry(row) gives the start. Rays
    are rows of raymat, or generated (with the object transform of the
    pack when xform)."""
    dev = frus.device
    nsub = cfg.sub_frusta
    counts = ccount.cpu()
    ccand_h = ccand.cpu()
    centry_h = centry.cpu()
    smask = _sub_masks(nsub, cfg.sub_rows, dev)
    lane = torch.arange(128, dtype=torch.int32, device=dev)
    idx = torch.arange(TILE, device=dev)
    col_f = (idx % culling.TILE_W).to(torch.float32)
    row_f = (idx // culling.TILE_W).to(torch.float32)
    for n in range(frus.shape[0]) if rows is None else rows:
        cnt = min(int(counts[n]), ccand.shape[1])
        if cnt <= 0:
            continue
        if raymat is None:
            rays = _raygen(frus[n], nsub, cfg, col_f, row_f, xform)
        else:
            rays = tuple(raymat[n, r] for r in range(7))
        tabs = functools.partial(_cluster_tables, tables, compressed_,
                                 corners, apex=frus[n, 0:3])
        yield n, rays, _trace_tile_plain(
            frus[n], rays, raymat is None, ccand_h[n], centry_h[n], cnt,
            meta, tabs, cfg, nsub, smask, lane, carry(n))


def trace_fused_plain(ccand, ccount, centry, frus, meta, tables,
                      cfg: RenderConfig, *, tiles_per_frame: int, tx: int,
                      pw: int, ph: int, raymat=None, compressed=False,
                      corners=None, rows=None):
    """Plain-PyTorch version of the fused trace kernel (same inputs and
    outputs as trace_fused). Runs on any device; on the card it is only
    the kernel's yardstick. rows: trace only these tile rows (the others
    stay background with zero counts, as empty tiles do)."""
    dev = frus.device
    n_rows = frus.shape[0]
    n_frames = n_rows // tiles_per_frame
    th, tw = culling.TILE_H, culling.TILE_W
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    image = bg.expand(n_frames, ph, pw, 3).clone()
    visits = torch.zeros(n_rows, dtype=torch.int32)
    eligible = torch.zeros(n_rows, dtype=torch.int32)
    zero = torch.zeros(TILE, dtype=torch.float32, device=dev)

    def fresh(_):
        return torch.full_like(zero, BIG), [zero, zero, zero], 0, 0

    for n, rays, (bt, bn, nv, ne) in _plain_walks(
            ccand, ccount, centry, frus, raymat, meta, tables, cfg, fresh,
            compressed, corners, rows):
        # Epilogue: normalise the selected normal, shade against -d.
        nn = torch.clamp_min(
            torch.sqrt(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2]), 1e-20)
        rgb = shading.shade_rows(bn[0] / nn, bn[1] / nn, bn[2] / nn,
                                 -rays[0], -rays[1], -rays[2], bt < BIG, cfg)
        f, t = divmod(n, tiles_per_frame)
        y0, x0 = (t // tx) * th, (t % tx) * tw
        image[f, y0:y0 + th, x0:x0 + tw] = torch.stack(
            rgb, dim=-1).reshape(th, tw, 3)
        visits[n] = nv
        eligible[n] = ne
    return image, visits.to(dev), eligible.to(dev)


def trace_windowed_plain(ccand, ccount, centry, frus, raymat, carry, meta,
                         tables, cfg: RenderConfig, *, compressed=False,
                         corners=None, rows=None):
    """Plain-PyTorch version of the windowed trace kernel (same inputs and
    outputs as trace_windowed). rows: trace only these tile rows (the
    others pass their carries through, as empty tiles do)."""
    t_in, n_in, vis_in, elig_in = carry
    t_out, n_out = t_in.clone(), n_in.clone()
    vis_out, elig_out = vis_in.cpu().clone(), elig_in.cpu().clone()

    def start(n):
        return (t_in[n], [n_in[n, 0], n_in[n, 1], n_in[n, 2]],
                int(vis_out[n]), int(elig_out[n]))

    for n, _, (bt, bn, nv, ne) in _plain_walks(
            ccand, ccount, centry, frus, raymat, meta, tables, cfg, start,
            compressed, corners, rows):
        t_out[n] = bt
        n_out[n] = torch.stack(bn)
        vis_out[n] = nv
        elig_out[n] = ne
    dev = frus.device
    return t_out, n_out, vis_out.to(dev), elig_out.to(dev)


def trace_raw_plain(ccand, ccount, centry, frus, meta, tables,
                    cfg: RenderConfig, *, raymat=None, compressed=False,
                    corners=None, rows=None):
    """Plain-PyTorch version of the raw trace kernel (same inputs and
    outputs as trace_raw). rows: trace only these tile rows (the others
    come back as misses with zero counts, as empty rows do)."""
    dev = frus.device
    n_rows = frus.shape[0]
    out = torch.zeros((n_rows, 4, TILE), dtype=torch.float32, device=dev)
    out[:, 0] = BIG
    visits = torch.zeros(n_rows, dtype=torch.int32)
    eligible = torch.zeros(n_rows, dtype=torch.int32)
    zero = torch.zeros(TILE, dtype=torch.float32, device=dev)

    def fresh(_):
        return torch.full_like(zero, BIG), [zero, zero, zero], 0, 0

    for n, _, (bt, bn, nv, ne) in _plain_walks(
            ccand, ccount, centry, frus, raymat, meta, tables, cfg, fresh,
            compressed, corners, rows, xform=raymat is None):
        out[n] = torch.stack([bt, *bn])
        visits[n] = nv
        eligible[n] = ne
    return out, visits.to(dev), eligible.to(dev)


# ----------------------------------------------------------------------
# Kernel wrappers.

def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fp = ctypes.POINTER(ctypes.c_float)
    fused = lib.rtmm_tile_trace_fused
    fused.argtypes = ([vp] * 9 + [ci]                 # inputs, grid rows
                      + [vp] * 3                      # outputs
                      + [ci] * 9 + [fp, ci, vp])      # sizes, params, stream
    fused.restype = ci
    windowed = lib.rtmm_tile_trace_windowed
    windowed.argtypes = ([vp] * 9 + [ci]              # inputs, grid rows
                         + [vp] * 8                   # carries in, out
                         + [ci] * 5 + [fp, ci, vp])
    windowed.restype = ci
    raw = lib.rtmm_tile_trace_raw
    raw.argtypes = ([vp] * 9 + [ci]                   # inputs, grid rows
                    + [vp] * 3                        # outputs
                    + [ci] * 5 + [fp, ci, vp])
    raw.restype = ci
    err = lib.rtmm_cuda_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fused, windowed, raw, err


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_common(ccand, ccount, centry, frus, raymat, meta, tables, cfg,
                  compressed_, corners, xform=False):
    """Device, type and shape checks shared by the wrappers; returns
    (device, kc, grid rows or 0). xform: a pack without a ray matrix also
    carries the object transform block."""
    dev = frus.device
    for name, x in (("ccand", ccand), ("ccount", ccount),
                    ("centry", centry), ("raymat", raymat), ("meta", meta),
                    ("tables", tables), ("corners", corners)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, frus on {dev}")
    n_rows, kc = ccand.shape
    pack = frus.shape[1]
    nsub, nrows = cfg.sub_frusta, cfg.sub_rows
    if not (0 < nsub <= MAX_SUB and nsub % nrows == 0
            and culling.TILE_H % nrows == 0
            and culling.TILE_W % (nsub // nrows) == 0):
        raise ValueError(f"unsupported sub-cone grid {nsub}/{nrows}")
    if pack != tiled.frustum_pack_len(nsub, with_raygen=raymat is None,
                                      with_xform=xform and raymat is None):
        raise ValueError(f"frus pack length {pack} does not match "
                         f"sub_frusta={nsub} "
                         f"{'with' if raymat is None else 'without'} raygen"
                         + (" and object transform" if xform else ""))
    n_cl = meta.shape[0]
    _check("ccand", ccand, torch.int32, (n_rows, kc))
    _check("ccount", ccount, torch.int32, (n_rows,))
    _check("centry", centry, torch.float32, (n_rows, kc))
    _check("frus", frus, torch.float32, (n_rows, pack))
    if raymat is not None:
        _check("raymat", raymat, torch.float32, (n_rows, 8, TILE))
    _check("meta", meta, torch.float32, (n_cl, 8, 128))
    if not compressed_:
        _check("unit_qn", tables, torch.float32,
               (n_cl * UPC, 8, 4 * LPU + 128))
        return dev, kc, 0
    grows = tables.shape[1] if tables.dim() == 3 else -1
    if corners is None:
        _check("unit_grid", tables, torch.float32,
               (n_cl * UPC, compressed.IDX_ROWS, compressed.GRID_LANES))
    else:
        if grows not in (compressed.GRID_ROWS, compressed.IDX_ROWS):
            raise ValueError(f"unit_grid has {grows} rows")
        _check("unit_grid", tables, torch.float32,
               (n_cl * UPC, grows, compressed.GRID_LANES))
        _check("corners", corners, torch.int32, (3, LPU))
    return dev, kc, tables.shape[1]


def _lib():
    from . import _build
    return _bind(_build.load("tile_trace"))


def _raise_on(rc, err_str):
    if rc != 0:
        raise RuntimeError("tile_trace kernel launch failed: "
                           + err_str(rc).decode())


OCCUPANCY_KEYS = ("registers", "local_bytes", "shared_bytes",
                  "blocks_per_sm", "threads", "rays_per_thread")


def occupancy() -> dict:
    """For each kernel entry of KERNELS, its CUDA instantiation as the
    runtime reports it on the current card: registers per thread, local
    (spill) bytes per thread, static shared bytes, resident blocks per SM,
    threads per block and rays per thread."""
    from . import _build
    lib = _build.load("tile_trace")
    fn = lib.rtmm_tile_trace_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = len(OCCUPANCY_KEYS)
    out = (ctypes.c_int * (n * len(KERNELS)))()
    _raise_on(fn(out), _lib()[3])
    return {name: dict(zip(OCCUPANCY_KEYS, out[n * j:n * (j + 1)]))
            for j, name in enumerate(KERNELS)}


def reciprocal_check(device) -> tuple[int, int]:
    """The kernel's branch-free reciprocal (rcp_newton in
    csrc/tile_trace.cu) against the correctly rounded 1.0f / x on every
    float32 bit pattern in its range, on the card: (mismatches, inputs
    in range). The kernel is exact where the first is 0."""
    from . import _build
    fn = _build.load("tile_trace").rtmm_tile_trace_rcp_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        rc = fn(out.data_ptr(),
                torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(rc, _lib()[3])
    return int(out[0]), int(out[1])


def trace_fused(ccand, ccount, centry, frus, meta, tables,
                cfg: RenderConfig, *, tiles_per_frame: int, tx: int,
                pw: int, ph: int, raymat=None, compressed=False,
                corners=None):
    """Fused trace + shade of every tile row of frus.

    ccand (N, kc) int32, ccount (N,) int32, centry (N, kc) f32: per-tile
    front-to-back cluster lists; frus (N, pack) f32 per-tile scalar pack
    (tiled.frustum_scalars, with the raygen scalars unless raymat is
    given); raymat (N, 8, TILE) f32 ray rows [d, a x d, s, 1], or None for
    in-kernel raygen; meta (C, 8, 128) f32. tables: unit_qn (U, 8, 4*LPU +
    128) f32, or with compressed=True the records unit_grid (U, rows, 128)
    f32 and corners the (3, LPU) int32 shared corner lanes (None: each
    record's index rows 3-5). Rows are frame-major, with tiles_per_frame
    rows per frame, tx tiles across.

    Returns (image (F, ph, pw, 3) f32, visits (N,) int32, eligible (N,)
    int32). On CUDA tensors the CUDA kernel runs (csrc/tile_trace.cu); on
    CPU tensors the plain version.
    """
    dev, _, grows = _check_common(ccand, ccount, centry, frus, raymat, meta,
                                  tables, cfg, compressed, corners)
    n_rows, kc = ccand.shape
    if (n_rows % tiles_per_frame or pw != tx * culling.TILE_W
            or tiles_per_frame != tx * (ph // culling.TILE_H)):
        raise ValueError("tile grid does not match the row count")
    if dev.type == "cpu":
        return trace_fused_plain(
            ccand, ccount, centry, frus, meta, tables, cfg,
            tiles_per_frame=tiles_per_frame, tx=tx, pw=pw, ph=ph,
            raymat=raymat, compressed=compressed, corners=corners)
    if dev.type != "cuda":
        raise ValueError(f"trace_fused runs on cuda or cpu, not {dev}")
    params = shade_params(cfg)
    fn, _, _, err_str = _lib()
    n_frames = n_rows // tiles_per_frame
    image = torch.empty((n_frames, ph, pw, 3), dtype=torch.float32,
                        device=dev)
    visits = torch.empty(n_rows, dtype=torch.int32, device=dev)
    eligible = torch.empty(n_rows, dtype=torch.int32, device=dev)
    hp = (ctypes.c_float * len(params))(*params.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ccand.data_ptr(), ccount.data_ptr(), centry.data_ptr(),
                frus.data_ptr(), _ptr(raymat), meta.data_ptr(),
                None if compressed else tables.data_ptr(),
                tables.data_ptr() if compressed else None, _ptr(corners),
                grows, image.data_ptr(), visits.data_ptr(),
                eligible.data_ptr(), n_rows, kc, frus.shape[1],
                tiles_per_frame, tx, pw, ph, cfg.sub_frusta, cfg.sub_rows,
                hp, len(params), stream)
    _raise_on(rc, err_str)
    LAUNCHES["tile_trace_fused_compressed" if compressed
             else "tile_trace_fused"] += 1
    return image, visits, eligible


def trace_windowed(ccand, ccount, centry, frus, raymat, carry, meta, tables,
                   cfg: RenderConfig, *, compressed=False, corners=None):
    """One cluster window of every tile row of frus (no shading).

    Inputs as trace_fused, with frus packed without raygen scalars and
    raymat required. carry = (t (N, TILE) f32 best apex-relative t, BIG =
    miss; n (N, 3, TILE) f32 summed winner normals, unnormalised, as the
    TPU kernel's normal rows carry them; visits (N,) int32; eligible (N,)
    int32), from the previous window (BIG / 0 for the first). Returns the
    updated carry; tiles with no cluster in this window pass theirs
    through. On CUDA tensors the CUDA kernel runs; on CPU tensors the
    plain version.
    """
    if raymat is None:
        raise ValueError("the windowed mode takes its rays from raymat")
    dev, _, grows = _check_common(ccand, ccount, centry, frus, raymat, meta,
                                  tables, cfg, compressed, corners)
    n_rows, kc = ccand.shape
    t_in, n_in, vis_in, elig_in = carry
    _check("t_in", t_in, torch.float32, (n_rows, TILE))
    _check("n_in", n_in, torch.float32, (n_rows, 3, TILE))
    _check("vis_in", vis_in, torch.int32, (n_rows,))
    _check("elig_in", elig_in, torch.int32, (n_rows,))
    for name, x in (("t_in", t_in), ("n_in", n_in), ("vis_in", vis_in),
                    ("elig_in", elig_in)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, frus on {dev}")
    if dev.type == "cpu":
        return trace_windowed_plain(ccand, ccount, centry, frus, raymat,
                                    carry, meta, tables, cfg,
                                    compressed=compressed, corners=corners)
    if dev.type != "cuda":
        raise ValueError(f"trace_windowed runs on cuda or cpu, not {dev}")
    params = shade_params(cfg)
    _, fn, _, err_str = _lib()
    t_out = torch.empty_like(t_in)
    n_out = torch.empty_like(n_in)
    vis_out = torch.empty_like(vis_in)
    elig_out = torch.empty_like(elig_in)
    hp = (ctypes.c_float * len(params))(*params.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ccand.data_ptr(), ccount.data_ptr(), centry.data_ptr(),
                frus.data_ptr(), raymat.data_ptr(), meta.data_ptr(),
                None if compressed else tables.data_ptr(),
                tables.data_ptr() if compressed else None, _ptr(corners),
                grows, t_in.data_ptr(), n_in.data_ptr(), vis_in.data_ptr(),
                elig_in.data_ptr(), t_out.data_ptr(), n_out.data_ptr(),
                vis_out.data_ptr(), elig_out.data_ptr(), n_rows, kc,
                frus.shape[1], cfg.sub_frusta, cfg.sub_rows, hp,
                len(params), stream)
    _raise_on(rc, err_str)
    LAUNCHES["tile_trace_windowed_compressed" if compressed
             else "tile_trace_windowed"] += 1
    return t_out, n_out, vis_out, elig_out


def trace_raw(ccand, ccount, centry, frus, meta, tables, cfg: RenderConfig,
              *, raymat=None, compressed=False, corners=None):
    """Raw trace of every tile row of frus: fresh start, no shading.

    Inputs as trace_fused. raymat (N, 8, TILE) f32 gives the rows' rays,
    with frus packed without raygen scalars; raymat None generates them
    in the kernel with the row's object transform, frus packed [apex_o 3,
    sub planes 12 nsub (object space), px0, py0, ivp 16, object-space
    scene box 6, R^T 9 row-major, 1/scale, apex_w 3, pad]
    (tiled.frustum_pack_len(nsub, with_xform=True)): s is taken against
    apex_w and scaled by 1/scale, the moments about apex_o, so t, t_min
    and t_max are in object units.

    Returns (out (N, 4, TILE) f32 rows [t (BIG = miss), summed winner
    normal xyz, unnormalised], visits (N,) int32, eligible (N,) int32);
    rows with ccount 0 are misses. On CUDA tensors the CUDA kernel runs;
    on CPU tensors the plain version.
    """
    dev, _, grows = _check_common(ccand, ccount, centry, frus, raymat, meta,
                                  tables, cfg, compressed, corners,
                                  xform=True)
    n_rows, kc = ccand.shape
    if dev.type == "cpu":
        return trace_raw_plain(ccand, ccount, centry, frus, meta, tables,
                               cfg, raymat=raymat, compressed=compressed,
                               corners=corners)
    if dev.type != "cuda":
        raise ValueError(f"trace_raw runs on cuda or cpu, not {dev}")
    params = shade_params(cfg)
    _, _, fn, err_str = _lib()
    out = torch.empty((n_rows, 4, TILE), dtype=torch.float32, device=dev)
    visits = torch.empty(n_rows, dtype=torch.int32, device=dev)
    eligible = torch.empty(n_rows, dtype=torch.int32, device=dev)
    hp = (ctypes.c_float * len(params))(*params.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ccand.data_ptr(), ccount.data_ptr(), centry.data_ptr(),
                frus.data_ptr(), _ptr(raymat), meta.data_ptr(),
                None if compressed else tables.data_ptr(),
                tables.data_ptr() if compressed else None, _ptr(corners),
                grows, out.data_ptr(), visits.data_ptr(),
                eligible.data_ptr(), n_rows, kc, frus.shape[1],
                cfg.sub_frusta, cfg.sub_rows, hp, len(params), stream)
    _raise_on(rc, err_str)
    LAUNCHES["tile_trace_raw_compressed" if compressed
             else "tile_trace_raw"] += 1
    return out, visits, eligible


# ----------------------------------------------------------------------
# Frame entry points (render_pallas / render_pallas_frames).

def clusters_per_window(scene: DeviceScene, cfg: RenderConfig) -> int:
    """kc: the per-tile cluster-list capacity of one launch. A scene with
    more clusters is traced in windows of kc clusters."""
    return max(1, min(cfg.kernel_clusters_per_window, scene.num_clusters))


def cluster_lists(scene: DeviceScene, fi: tiled.FrameInputs, kc: int):
    """Per-tile front-to-back cluster lists of every cluster the tile's
    frustum hits, exactly jax.lax.top_k's: ascending apex distance, ties
    to the lower cluster index, centry = +inf past ccount. Returns (ccand
    (tiles, kc) int32, ccount (tiles,) int32, centry (tiles, kc) f32)."""
    return tiled.cluster_window(scene, fi.apex, fi.cluster_hit, kc)[:3]


def frame_inputs(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                 kc: int):
    """One frame's launch inputs for in-kernel raygen: (ccand, ccount,
    centry, frus)."""
    pw, _ = tiled.padded_size(cfg.width, cfg.height)
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32,
                          device=scene.device)
    fi = tiled.build_frame_inputs(scene, ivp, cfg, need_rays=False)
    frus = tiled.frustum_scalars(fi, raygen_ivp=ivp,
                                 tx=pw // culling.TILE_W)
    return (*cluster_lists(scene, fi, kc), frus)


def ray_frame_inputs(scene: DeviceScene, inv_view_proj, cfg: RenderConfig):
    """One frame's inputs with a ray matrix: (fi, frus without raygen
    scalars, raymat (tiles, 8, TILE) rows [d, a x d, s, 1])."""
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32,
                          device=scene.device)
    fi = tiled.build_frame_inputs(scene, ivp, cfg, need_rays=True)
    return (fi, tiled.frustum_scalars(fi),
            fi.raymat.transpose(1, 2).contiguous())


def _launch(scene, cfg, rows, raymat=None):
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    ccand, ccount, centry, frus = rows
    meta, tables, opts = scene_tables(scene)
    return trace_fused(ccand, ccount, centry, frus, meta, tables, cfg,
                       tiles_per_frame=tx * ty, tx=tx, pw=pw, ph=ph,
                       raymat=raymat, **opts)


def _to_image(colors, cfg):
    """(tiles, TILE, 3) tile-major colors -> (H, W, 3)."""
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    return (colors.reshape(ty, tx, culling.TILE_H, culling.TILE_W, 3)
            .permute(0, 2, 1, 3, 4).reshape(ph, pw, 3))[:cfg.height,
                                                        :cfg.width]


def render_windowed(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                    kc: int):
    """One frame in cluster windows of kc clusters (render_pallas's
    windowed branch): the ray matrix, carries t = BIG and normals 0, one
    windowed launch per window (tiled.trace_windowed_clusters), then the
    normalised normal shaded against -d in the row form of the fused
    kernel's epilogue. Returns (image (H, W, 3),
    visits (tiles,), eligible (tiles,), number of windows)."""
    fi, frus, raymat = ray_frame_inputs(scene, inv_view_proj, cfg)
    meta, tables, opts = scene_tables(scene)
    n_tiles = frus.shape[0]
    dev = frus.device

    def trace_window(ccand, ccount, centry, best_t, rest):
        t, n, vis, elig = trace_windowed(ccand, ccount, centry, frus, raymat,
                                         (best_t, *rest), meta, tables, cfg,
                                         **opts)
        return t, (n, vis, elig)

    init_t = torch.full((n_tiles, TILE), BIG, dtype=torch.float32,
                        device=dev)
    init_n = (torch.zeros((n_tiles, 3, TILE), dtype=torch.float32,
                          device=dev),
              torch.zeros(n_tiles, dtype=torch.int32, device=dev),
              torch.zeros(n_tiles, dtype=torch.int32, device=dev))
    best_t, (n, visits, eligible), windows = tiled.trace_windowed_clusters(
        scene, fi, trace_window, init_t, init_n, kc)
    # The fused kernel's epilogue (shade_rows, the row form of
    # shade_or_miss): normalise the summed winner normal, shade against -d.
    nn = torch.clamp_min(torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                                    + n[:, 2] * n[:, 2]), 1e-20)
    d = raymat[:, 0:3]
    rgb = shading.shade_rows(n[:, 0] / nn, n[:, 1] / nn, n[:, 2] / nn,
                             -d[:, 0], -d[:, 1], -d[:, 2], best_t < BIG, cfg)
    return (_to_image(torch.stack(rgb, dim=-1), cfg), visits, eligible,
            windows)


def render_frame(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                 with_stats: bool = False):
    """Render one frame on the scene's device. Returns (H, W, 3) f32, or
    ((H, W, 3), stats) with stats["kernel_unit_visits"] and
    stats["kernel_unit_eligible"] the per-tile (ty, tx) int32 counts of
    unit visits and walk picks, and stats["windows"] the launches.

    Fused (one launch, shaded in-kernel) when the scene has at most
    kernel_clusters_per_window clusters, with in-kernel raygen unless
    cfg.kernel_raygen is False (then from a ray matrix); windowed
    otherwise."""
    kc = clusters_per_window(scene, cfg)
    if scene.num_clusters > kc:
        img, visits, eligible, windows = render_windowed(
            scene, inv_view_proj, cfg, kc)
    else:
        if cfg.kernel_raygen:
            image, visits, eligible = _launch(
                scene, cfg, frame_inputs(scene, inv_view_proj, cfg, kc))
        else:
            fi, frus, raymat = ray_frame_inputs(scene, inv_view_proj, cfg)
            image, visits, eligible = _launch(
                scene, cfg, (*cluster_lists(scene, fi, kc), frus), raymat)
        img, windows = image[0, :cfg.height, :cfg.width], 1
    if not with_stats:
        return img
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    shape = (ph // culling.TILE_H, pw // culling.TILE_W)
    return img, {"kernel_unit_visits": visits.reshape(shape),
                 "kernel_unit_eligible": eligible.reshape(shape),
                 "windows": windows}


def render_frames(scene: DeviceScene, inv_view_projs,
                  cfg: RenderConfig) -> torch.Tensor:
    """Render a batch of frames, F = len(inv_view_projs). Fused frames
    with in-kernel raygen batch into as few launches as BATCH_TILE_CAP
    allows (equal chunks): every kernel input is per tile, so frames batch
    by concatenating their tile rows. Windowed scenes (and ray-matrix
    input) render frame by frame. Returns (F, H, W, 3) f32."""
    kc = clusters_per_window(scene, cfg)
    if not isinstance(inv_view_projs, torch.Tensor):
        inv_view_projs = torch.from_numpy(np.asarray(inv_view_projs))
    ivps = inv_view_projs.to(device=scene.device, dtype=torch.float32)
    f_total = ivps.shape[0]
    if scene.num_clusters > kc or not cfg.kernel_raygen:
        return torch.stack([render_frame(scene, ivps[i], cfg)
                            for i in range(f_total)])
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    n_tiles = (pw // culling.TILE_W) * (ph // culling.TILE_H)
    f = max(1, min(f_total, BATCH_TILE_CAP // n_tiles))
    while f_total % f:
        f -= 1
    out = []
    for c0 in range(0, f_total, f):
        per_frame = [frame_inputs(scene, ivps[i], cfg, kc)
                     for i in range(c0, c0 + f)]
        rows = [torch.cat(parts) for parts in zip(*per_frame)]
        out.append(_launch(scene, cfg, rows)[0])
    images = out[0] if len(out) == 1 else torch.cat(out)
    return images[:, :cfg.height, :cfg.width]
