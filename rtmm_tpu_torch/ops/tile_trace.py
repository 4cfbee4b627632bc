"""Fused tile trace + shade: the port of the JAX package's Pallas trace
kernel in its main-path mode (rtmm_tpu/ops/pallas_tiled.py::trace_pallas,
fused + in-kernel raygen + precomputed tables; body _kernel ->
_trace_tile_nonempty).

One launch renders whole frames. For each 32x32 ray tile it generates the
rays, walks the tile's front-to-back cluster list, culls each cluster's 64
units against the tile's sub-cones and per-sub worst-hit bounds, visits
the two nearest eligible units per step (recentered-moment Möller-Trumbore
over the unit's 64 leaves, strict-< running best), stops when no remaining
cluster can beat the tile's worst hit, and shades the closest hits.

  trace_fused        the wrapper: launches the CUDA kernel
                     (csrc/tile_trace.cu) on CUDA tensors; on CPU tensors
                     it runs trace_fused_plain.
  trace_fused_plain  the same walk in plain PyTorch (a Python loop over
                     tiles, clusters and picks; each unit visit vectorised
                     over 64 leaves x 1,024 rays), operation for operation
                     the kernel's arithmetic.
  LAUNCHES           kernel launches so far (a plain integer).
  render_frame       one frame: prologue + one launch (render_pallas).
  render_frames      F frames in one launch (render_pallas_frames).

Semantics kept from the TPU kernel: the w-form acceptance
min(u, v, w) >= -MT_UV_EPS with no det guard, the p-form t-window (p = t +
s against [t_min + s, t_max + s], the upper side applied to the leaf
minimum), the tie-summed winner normal, the strict-< fold, pick-2 on
integer (distance | lane) keys, and the visit/eligible counters.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from . import _f32, culling, shading, tiled
from .intersect import MT_UV_EPS

BIG = 1e30
IMAX = 0x7FFFFFFF
TILE = culling.TILE_H * culling.TILE_W
UPC = culling.UNITS_PER_CLUSTER
LPU = 64
MAX_SUB = 8
# Tile rows per launch in render_frames: 32 frames of 1080p (2,040 tiles
# each) fit in one launch; the rgb output is then ~0.8 GB of float32.
BATCH_TILE_CAP = 65536

LAUNCHES = 0

_K1B = ("scenes with more clusters than cfg.kernel_clusters_per_window "
        "need the windowed kernel mode (K1b): later slice")


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
# Plain PyTorch version.

def _worst_subs(bt, s, exit_t, smask):
    """Per-sub-tile worst-case reach (floored at 0): a ray contributes its
    hit's apex-relative t, or — while it still misses — its scene-AABB
    exit t."""
    v = torch.where(bt < BIG, bt + s, exit_t)
    return torch.stack([torch.where(m, v, 0.0).amax() for m in smask])


def _trace_tile_plain(fr, ccand_row, centry_row, cnt, meta, unit_qn,
                      cfg, nsub, smask, lane, col_f, row_f):
    """One tile: returns (rgb (TILE, 3), visits, eligible)."""
    rg = 3 + nsub * 12

    def m(i, j):
        return fr[rg + 2 + 4 * i + j]

    # In-kernel raygen (pallas_tiled._raygen_rows): true divisions.
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
    s = (ox - ax) * dx + (oy - ay) * dy + (oz - az) * dz
    mx = ay * dz - az * dy
    my = az * dx - ax * dz
    mz = ax * dy - ay * dx

    # Per-ray scene-exit reach through the inflated scene AABB.
    sb = rg + 18
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

    bt = torch.full_like(s, BIG)
    bn = [torch.zeros_like(s) for _ in range(3)]
    nv = ne = 0

    def process(cl, u, crow):
        """One unit visit: fold its 64 leaves into the running best."""
        nonlocal bt, bn
        q = unit_qn[cl * UPC + u]                       # (8, 4*LPU + 128)
        qd = q[0:6, 0:LPU]
        qu = q[0:6, LPU:2 * LPU]
        qv = q[0:6, 2 * LPU:3 * LPU]
        qw = (qd - qu) - qv                             # w on the q columns
        nrm = q[0:4, 4 * LPU:5 * LPU]
        cx, cy, cz = crow[0, u], crow[1, u], crow[2, u]
        s_neg = (ax - cx) * qd[0] + (ay - cy) * qd[1] + (az - cz) * qd[2]
        tn = -s_neg - nrm[3]
        # Recentered moment m' = (a - c) x d = m - c x d.
        rows = (dx, dy, dz,
                mx - (cy * dz - cz * dy),
                my - (cz * dx - cx * dz),
                mz - (cx * dy - cy * dx))

        def contract(qb):
            acc = qb[0][:, None] * rows[0][None, :]
            for r in range(1, 6):
                acc = acc + qb[r][:, None] * rows[r][None, :]
            return acc                                  # (LPU, TILE)

        det = contract(qd)
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
            process(cl, ua, crow)
            if hasb:
                # (The TPU kernel recomputes unit A in a slot with no B:
                # an idempotent fold, skipped here.)
                process(cl, ub, crow)
            ws = _worst_subs(bt, s, exit_t, smask)
            removed = ikey >= IMAX
            ua, ub, ikey = pick2(torch.where(removed, IMAX,
                                             keys(ws, removed)))
            nv += 1 + int(hasb)
            ne += 1 + int(hasb)
        ci += 1

    # Epilogue: normalise the selected normal, shade against -d.
    nn = torch.clamp_min(
        torch.sqrt(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2]), 1e-20)
    rgb = shading.shade_rows(bn[0] / nn, bn[1] / nn, bn[2] / nn,
                             -dx, -dy, -dz, bt < BIG, cfg)
    return torch.stack(rgb, dim=-1), nv, ne


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


def trace_fused_plain(ccand, ccount, centry, frus, meta, unit_qn,
                      cfg: RenderConfig, *, tiles_per_frame: int, tx: int,
                      pw: int, ph: int):
    """Plain-PyTorch version of the fused trace kernel (same inputs and
    outputs as trace_fused). Runs on any device; on the card it is only
    the kernel's yardstick."""
    dev = frus.device
    n_rows = frus.shape[0]
    n_frames = n_rows // tiles_per_frame
    nsub = cfg.sub_frusta
    image = torch.empty((n_frames, ph, pw, 3), dtype=torch.float32,
                        device=dev)
    visits = torch.zeros(n_rows, dtype=torch.int32)
    eligible = torch.zeros(n_rows, dtype=torch.int32)
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    counts = ccount.cpu()
    ccand_h = ccand.cpu()
    centry_h = centry.cpu()
    smask = _sub_masks(nsub, cfg.sub_rows, dev)
    lane = torch.arange(128, dtype=torch.int32, device=dev)
    idx = torch.arange(TILE, device=dev)
    col_f = (idx % culling.TILE_W).to(torch.float32)
    row_f = (idx // culling.TILE_W).to(torch.float32)
    th, tw = culling.TILE_H, culling.TILE_W
    for n in range(n_rows):
        f, t = divmod(n, tiles_per_frame)
        y0, x0 = (t // tx) * th, (t % tx) * tw
        cnt = min(int(counts[n]), ccand.shape[1])
        if cnt <= 0:
            image[f, y0:y0 + th, x0:x0 + tw] = bg
            continue
        rgb, nv, ne = _trace_tile_plain(
            frus[n], ccand_h[n], centry_h[n], cnt, meta, unit_qn, cfg,
            nsub, smask, lane, col_f, row_f)
        image[f, y0:y0 + th, x0:x0 + tw] = rgb.reshape(th, tw, 3)
        visits[n] = nv
        eligible[n] = ne
    return image, visits.to(dev), eligible.to(dev)


# ----------------------------------------------------------------------
# Kernel wrapper.

def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bind(lib):
    fn = lib.rtmm_tile_trace_fused
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp,          # inputs
                   vp, vp, vp,                      # outputs
                   ci, ci, ci, ci, ci, ci, ci, ci, ci,
                   ctypes.POINTER(ctypes.c_float), ci,
                   vp]                              # stream
    fn.restype = ci
    err = lib.rtmm_cuda_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fn, err


def trace_fused(ccand, ccount, centry, frus, meta, unit_qn,
                cfg: RenderConfig, *, tiles_per_frame: int, tx: int,
                pw: int, ph: int):
    """Fused trace + shade of every tile row of frus.

    ccand (N, kc) int32, ccount (N,) int32, centry (N, kc) f32: per-tile
    front-to-back cluster lists; frus (N, pack) f32 per-tile scalar pack
    (tiled.frustum_scalars with raygen); meta (C, 8, 128) f32 and unit_qn
    (U, 8, 4*LPU + 128) f32: the scene tables. Rows are frame-major, with
    tiles_per_frame rows per frame, tx tiles across.

    Returns (image (F, ph, pw, 3) f32, visits (N,) int32, eligible (N,)
    int32). On CUDA tensors the CUDA kernel runs (csrc/tile_trace.cu); on
    CPU tensors the plain version.
    """
    global LAUNCHES
    dev = frus.device
    for name, x in (("ccand", ccand), ("ccount", ccount),
                    ("centry", centry), ("meta", meta),
                    ("unit_qn", unit_qn)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, frus on {dev}")
    if dev.type == "cpu":
        return trace_fused_plain(ccand, ccount, centry, frus, meta,
                                 unit_qn, cfg,
                                 tiles_per_frame=tiles_per_frame, tx=tx,
                                 pw=pw, ph=ph)
    if dev.type != "cuda":
        raise ValueError(f"trace_fused runs on cuda or cpu, not {dev}")
    n_rows, kc = ccand.shape
    pack = frus.shape[1]
    nsub, nrows = cfg.sub_frusta, cfg.sub_rows
    if not (0 < nsub <= MAX_SUB and nsub % nrows == 0
            and culling.TILE_H % nrows == 0
            and culling.TILE_W % (nsub // nrows) == 0):
        raise ValueError(f"unsupported sub-cone grid {nsub}/{nrows}")
    if pack != tiled.frustum_pack_len(nsub, with_raygen=True):
        raise ValueError(f"frus pack length {pack} does not match "
                         f"sub_frusta={nsub} with raygen")
    if (n_rows % tiles_per_frame or pw != tx * culling.TILE_W
            or tiles_per_frame != tx * (ph // culling.TILE_H)):
        raise ValueError("tile grid does not match the row count")
    n_cl = meta.shape[0]
    _check("ccand", ccand, torch.int32, (n_rows, kc))
    _check("ccount", ccount, torch.int32, (n_rows,))
    _check("centry", centry, torch.float32, (n_rows, kc))
    _check("frus", frus, torch.float32, (n_rows, pack))
    _check("meta", meta, torch.float32, (n_cl, 8, 128))
    _check("unit_qn", unit_qn, torch.float32, (n_cl * UPC, 8, 4 * LPU + 128))
    params = shade_params(cfg)

    from . import _build
    fn, err_str = _bind(_build.load("tile_trace"))
    n_frames = n_rows // tiles_per_frame
    image = torch.empty((n_frames, ph, pw, 3), dtype=torch.float32,
                        device=dev)
    visits = torch.empty(n_rows, dtype=torch.int32, device=dev)
    eligible = torch.empty(n_rows, dtype=torch.int32, device=dev)
    hp = (ctypes.c_float * len(params))(*params.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ccand.data_ptr(), ccount.data_ptr(), centry.data_ptr(),
                frus.data_ptr(), meta.data_ptr(), unit_qn.data_ptr(),
                image.data_ptr(), visits.data_ptr(), eligible.data_ptr(),
                n_rows, kc, pack, tiles_per_frame, tx, pw, ph, nsub, nrows,
                hp, len(params), stream)
    if rc != 0:
        raise RuntimeError("tile_trace kernel launch failed: "
                           + err_str(rc).decode())
    LAUNCHES += 1
    return image, visits, eligible


# ----------------------------------------------------------------------
# Frame entry points (render_pallas / render_pallas_frames).

def cluster_lists(scene: DeviceScene, fi: tiled.FrameInputs, kc: int):
    """Per-tile front-to-back cluster lists, exactly jax.lax.top_k's:
    ascending apex distance, ties to the lower cluster index, centry =
    +inf past ccount. Returns (ccand (tiles, kc) int32, ccount (tiles,)
    int32, centry (tiles, kc) f32)."""
    cl_dist = culling.aabb_distance(fi.apex, scene.cluster_aabb_min,
                                    scene.cluster_aabb_max)
    key = torch.where(fi.cluster_hit, cl_dist[None, :], float("inf"))
    skey, sidx = torch.sort(key, dim=1, stable=True)
    skey, sidx = skey[:, :kc], sidx[:, :kc]
    sel = skey < float("inf")
    return (sidx.to(torch.int32).contiguous(),
            sel.sum(dim=1).to(torch.int32),
            torch.where(sel, skey, float("inf")).contiguous())


def _window(scene: DeviceScene, cfg: RenderConfig) -> int:
    if not cfg.kernel_raygen:
        raise NotImplementedError(
            "kernel_raygen=False (ray-matrix input) belongs to the windowed "
            "kernel mode (K1b): later slice")
    kc = max(1, min(cfg.kernel_clusters_per_window, scene.num_clusters))
    if scene.num_clusters > kc:
        raise NotImplementedError(_K1B)
    return kc


def frame_inputs(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                 kc: int):
    """One frame's launch inputs: (ccand, ccount, centry, frus)."""
    pw, _ = tiled.padded_size(cfg.width, cfg.height)
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32,
                          device=scene.device)
    fi = tiled.build_frame_inputs(scene, ivp, cfg, need_rays=False)
    frus = tiled.frustum_scalars(fi, raygen_ivp=ivp,
                                 tx=pw // culling.TILE_W)
    return (*cluster_lists(scene, fi, kc), frus)


def _launch(scene, cfg, rows):
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    ccand, ccount, centry, frus = rows
    return trace_fused(ccand, ccount, centry, frus,
                       scene.cluster_unit_meta, scene.unit_qn, cfg,
                       tiles_per_frame=tx * ty, tx=tx, pw=pw, ph=ph)


def render_frame(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                 with_stats: bool = False):
    """Render one frame on the scene's device. Returns (H, W, 3) f32, or
    ((H, W, 3), stats) with stats["kernel_unit_visits"] and
    stats["kernel_unit_eligible"] the per-tile (ty, tx) int32 counts of
    unit visits and walk picks."""
    kc = _window(scene, cfg)
    image, visits, eligible = _launch(
        scene, cfg, frame_inputs(scene, inv_view_proj, cfg, kc))
    img = image[0, :cfg.height, :cfg.width]
    if not with_stats:
        return img
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    shape = (ph // culling.TILE_H, pw // culling.TILE_W)
    return img, {"kernel_unit_visits": visits.reshape(shape),
                 "kernel_unit_eligible": eligible.reshape(shape)}


def render_frames(scene: DeviceScene, inv_view_projs,
                  cfg: RenderConfig) -> torch.Tensor:
    """Render a batch of frames, F = len(inv_view_projs), in as few
    launches as BATCH_TILE_CAP allows (equal chunks). Every kernel input
    is per tile, so frames batch by concatenating their tile rows.
    Returns (F, H, W, 3) f32."""
    kc = _window(scene, cfg)
    if not isinstance(inv_view_projs, torch.Tensor):
        inv_view_projs = torch.from_numpy(np.asarray(inv_view_projs))
    ivps = inv_view_projs.to(device=scene.device, dtype=torch.float32)
    f_total = ivps.shape[0]
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
