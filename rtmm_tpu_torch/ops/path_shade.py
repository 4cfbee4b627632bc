"""The path tracer's per-lane work outside the trace: the draw and the
next ray (pt_spawn), the hit's shading (pt_shade).

On the TPU this is XLA-fused device code inside the JAX package's jitted
path_trace (rtmm_tpu/render/pathtrace.py: rand2 :342-350, the bounce
lines :472-487, the primaries :336-339 and :347-369); here it is two
hand-written kernels, csrc/path_shade.cu, one thread per lane.

  spawn / spawn_plain  the lane's randoms, jax.random's threefry on
                       (seed, bounce, g // total, g % total), the
                       cosine-weighted direction around its normal and
                       its next origin and direction. Two forms: a bounce
                       (idx and t given: the sorted state's lanes) and the
                       primaries (lanes given: spp x total lanes over the
                       n pixels, pad lanes dead).
  shade / shade_plain  the normal normalised and flipped toward the ray,
                       the background on escaped lanes and the direct
                       light on hits, times the bounce's throughput; the
                       primary form (rad None) where(hit, direct, bg).
  LAUNCHES             kernel launches so far.

The wrappers take the kernel for CUDA tensors (building it on first use;
a failed build or launch raises) and the plain version for CPU tensors.
The plain versions are the eager expressions of the path tracer; the
kernels do the same float32 operations in the same order, so the two
agree bit for bit on the card.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..utils import threefry
from . import culling, shading
from .tile_trace import _check

KERNELS = ("pt_spawn", "pt_shade")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------
# Plain PyTorch versions.

def direct_light(normal: torch.Tensor, albedo: torch.Tensor,
                 cfg: RenderConfig) -> torch.Tensor:
    """Diffuse direct lighting from the four reference lights
    (closesthit.hlsl:70-81), Lambertian only, Reinhard tone-mapped."""
    lo = torch.zeros(normal.shape[:-1] + (3,), dtype=torch.float32,
                     device=normal.device)
    for ldir, lscale in zip(shading.LIGHT_DIRS, shading.LIGHT_SCALE):
        n_dot_l = torch.clamp_min(normal[..., 0] * ldir[0]
                                  + normal[..., 1] * ldir[1]
                                  + normal[..., 2] * ldir[2], 0.0)
        radiance = cfg.light_intensity * lscale
        lo = lo + albedo * (radiance / np.pi) * n_dot_l[..., None]
    return lo / (lo + 1.0)


def cosine_dir(u: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction around `normal` from uniform
    u (..., 2)."""
    r = torch.sqrt(u[..., 0])
    phi = (2.0 * np.pi) * u[..., 1]
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    # Orthonormal basis around the normal.
    up = torch.where((torch.abs(normal[..., 2:3]) < 0.9),
                     shading._vec3((0.0, 0.0, 1.0), normal),
                     shading._vec3((1.0, 0.0, 0.0), normal))
    t = culling._cross(up, normal)
    t = t / torch.clamp_min(torch.sqrt(t[..., 0] * t[..., 0]
                                       + t[..., 1] * t[..., 1]
                                       + t[..., 2] * t[..., 2]),
                            1e-20)[..., None]
    b = culling._cross(normal, t)
    return x[..., None] * t + y[..., None] * b + z[..., None] * normal


def normalize_flip(bn: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Normalise an (unnormalised, reference-style) geometric normal and
    flip it toward the incoming ray."""
    nn = torch.sqrt(bn[:, 0] * bn[:, 0] + bn[:, 1] * bn[:, 1]
                    + bn[:, 2] * bn[:, 2])
    nrm = bn / torch.clamp_min(nn, 1e-20)[:, None]
    facing = (nrm[:, 0] * dirs[:, 0] + nrm[:, 1] * dirs[:, 1]
              + nrm[:, 2] * dirs[:, 2]) > 0.0
    return torch.where(facing[:, None], -nrm, nrm)


def rand2(key0, bounce: int, lanes: torch.Tensor, total: int):
    """(n, 2) randoms of bounce `bounce` for global lanes g = sample *
    total + pixel: uniform(fold_in(fold_in(fold_in(key0, bounce),
    g // total), g % total), (2,))."""
    kb = threefry.fold_in(key0, bounce)
    g = lanes.to(torch.int64)
    k = threefry.fold_in(threefry.fold_in(kb, g // total), g % total)
    return threefry.uniform2(k)


def spawn_plain(seed: int, bounce: int, total: int, nrm, hit, o, d, *,
                idx=None, t=None, lanes=None, with_u=False):
    """Plain version of pt_spawn (same arguments and returns as spawn)."""
    dev = o.device
    key0 = threefry.key(seed, dev)
    if t is None:
        pad = total - o.shape[0]
        spp = lanes // total

        def tile_s(x, value=0.0):
            x = torch.cat([x, torch.full((pad,) + x.shape[1:], value,
                                         dtype=x.dtype, device=dev)])
            return x.repeat((spp,) + (1,) * (x.dim() - 1))

        u = rand2(key0, bounce, torch.arange(lanes, dtype=torch.int32,
                                             device=dev), total)
        d1 = cosine_dir(u, tile_s(nrm))
        o_new = tile_s(o)
        d_new = torch.where(tile_s(hit, False)[:, None], d1,
                            tile_s(d, 1.0))
    else:
        u = rand2(key0, bounce, idx, total)
        hit_pos = o + torch.where(hit, t, 0.0)[:, None] * d
        new_dir = cosine_dir(u, nrm)
        o_new = hit_pos + 1e-4 * nrm
        d_new = torch.where(hit[:, None], new_dir, d)
    return (o_new, d_new, u) if with_u else (o_new, d_new)


def shade_plain(bn, d, hit, albedo: np.ndarray, bg: np.ndarray,
                cfg: RenderConfig, *, alive=None, rad=None, tp_b=None):
    """Plain version of pt_shade (same arguments as shade). Returns (rad,
    nrm)."""
    dev = bn.device
    albedo_t = torch.from_numpy(albedo).to(dev)
    bg_t = torch.from_numpy(bg).to(dev)
    nrm = normalize_flip(bn, d)
    if rad is None:
        return torch.where(hit[:, None], direct_light(nrm, albedo_t, cfg),
                           bg_t), nrm
    tp = torch.from_numpy(tp_b).to(dev)
    escaped = alive & ~hit
    rad = rad + torch.where(escaped[:, None], tp * bg_t, 0.0)
    direct = direct_light(nrm, albedo_t, cfg)
    rad = rad + torch.where(hit[:, None], tp * direct, 0.0)
    return rad, nrm


# ----------------------------------------------------------------------
# Kernel wrappers.

@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build
    lib = _build.load("path_shade")
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    spawn_fn = lib.rtmm_pt_spawn
    spawn_fn.argtypes = [ci] * 3 + [cu] * 2 + [vp] * 10
    spawn_fn.restype = ci
    shade_fn = lib.rtmm_pt_shade
    shade_fn.argtypes = ([ci] + [vp] * 7
                         + [ctypes.POINTER(ctypes.c_float), vp])
    shade_fn.restype = ci
    err = lib.rtmm_pt_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return spawn_fn, shade_fn, err


@functools.lru_cache(maxsize=64)
def _bounce_key(seed: int, bounce: int) -> tuple[int, int]:
    """fold_in(key(seed), bounce)'s two words, folded once on the host (a
    fold is ~100 CPU tensor ops)."""
    return tuple(int(w) for w in threefry.fold_in(threefry.key(seed),
                                                 bounce))


def _same_device(dev, **tensors):
    for name, x in tensors.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the path-shade kernels run on cuda or cpu, not "
                         f"{dev}")


def _contiguous(*tensors):
    """The kernels read dense rows: strided views (a trace's transposed
    normals) are copied."""
    return tuple(None if x is None else x.contiguous() for x in tensors)


def _raise(rc: int, name: str, err) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + err(rc).decode())


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(x):
    return None if x is None else x.data_ptr()


def spawn(seed: int, bounce: int, total: int, nrm, hit, o, d, *, idx=None,
          t=None, lanes=None, with_u=False):
    """The next rays of a bounce: per lane g the randoms u =
    uniform(fold_in(fold_in(fold_in(key(seed), bounce), g // total),
    g % total), (2,)) and the cosine-weighted direction around its normal.

    Bounce form (idx and t given): nrm (n, 3), hit (n,) bool, o, d (n, 3)
    and t (n,) f32 are the n lanes of the sorted state, idx (n,) int32
    their global lanes g; returns o + where(hit, t, 0) d + 1e-4 nrm and
    where(hit, dir, d). Primary form (lanes given, a multiple of total):
    nrm, hit, o (the bounce origins) and d of the n <= total primaries;
    lane g reads pixel g % total (pad lanes past n: nrm 0, hit False, o 0,
    d 1.0) and returns o and where(hit, dir, d) over the lanes.

    Returns (o, d) float32 (lanes, 3), and the (lanes, 2) uniforms last
    when with_u. CUDA tensors launch pt_spawn (csrc/path_shade.cu); CPU
    tensors run spawn_plain."""
    dev = o.device
    _same_device(dev, nrm=nrm, hit=hit, d=d, idx=idx, t=t)
    nrm, hit, o, d, idx, t = _contiguous(nrm, hit, o, d, idx, t)
    if t is None:
        n = o.shape[0]
        if idx is not None or lanes is None or lanes % total or n > total:
            raise ValueError("the primary form takes lanes, a multiple of "
                             f"total >= n (lanes {lanes}, total {total}, "
                             f"n {n}) and no idx")
        n_out = lanes
    else:
        if idx is None or lanes is not None:
            raise ValueError("the bounce form takes idx and no lanes")
        n = n_out = o.shape[0]
        _check("idx", idx, torch.int32, (n,))
        _check("t", t, torch.float32, (n,))
    for name, x in (("nrm", nrm), ("o", o), ("d", d)):
        _check(name, x, torch.float32, (n, 3))
    _check("hit", hit, torch.bool, (n,))
    if dev.type == "cpu":
        return spawn_plain(seed, bounce, total, nrm, hit, o, d, idx=idx,
                           t=t, lanes=lanes, with_u=with_u)
    spawn_fn, _, err = _lib()
    kb0, kb1 = _bounce_key(seed, bounce)
    o_out = torch.empty((n_out, 3), dtype=torch.float32, device=dev)
    d_out = torch.empty_like(o_out)
    u = (torch.empty((n_out, 2), dtype=torch.float32, device=dev)
         if with_u else None)
    with torch.cuda.device(dev):
        rc = spawn_fn(n_out, total, n, kb0, kb1, _ptr(idx), nrm.data_ptr(),
                      hit.data_ptr(), o.data_ptr(), d.data_ptr(), _ptr(t),
                      o_out.data_ptr(), d_out.data_ptr(), _ptr(u),
                      _stream(dev))
    _raise(rc, "pt_spawn", err)
    LAUNCHES["pt_spawn"] += 1
    return (o_out, d_out, u) if with_u else (o_out, d_out)


def _light_scales(cfg: RenderConfig) -> list[float]:
    """Per light, the intensity x scale / pi that direct_light multiplies
    the albedo by (a Python double; both versions round it to float32)."""
    return [cfg.light_intensity * s / np.pi for s in shading.LIGHT_SCALE]


def shade(bn, d, hit, albedo: np.ndarray, bg: np.ndarray,
          cfg: RenderConfig, *, alive=None, rad=None, tp_b=None):
    """Shading of n lanes: bn (n, 3) the trace's unnormalised normals, d
    (n, 3) the rays, hit (n,) bool; albedo, bg float32 (3,) arrays.

    Bounce form (rad given, with alive (n,) bool and the throughput tp_b,
    a float32 (3,) array): rad + where(alive & ~hit, tp_b bg, 0) +
    where(hit, tp_b direct, 0). Primary form (rad None): where(hit,
    direct, bg). Returns (rad, nrm): float32 (n, 3), nrm the normal
    normalised and flipped toward the ray. CUDA tensors launch pt_shade
    (csrc/path_shade.cu); CPU tensors run shade_plain."""
    dev = bn.device
    _same_device(dev, d=d, hit=hit, alive=alive, rad=rad)
    bn, d, hit, alive, rad = _contiguous(bn, d, hit, alive, rad)
    n = bn.shape[0]
    for name, x in (("bn", bn), ("d", d), ("rad", rad)):
        if x is not None:
            _check(name, x, torch.float32, (n, 3))
    _check("hit", hit, torch.bool, (n,))
    if rad is not None:
        if alive is None or tp_b is None:
            raise ValueError("the bounce form takes alive and tp_b")
        _check("alive", alive, torch.bool, (n,))
    if dev.type == "cpu":
        return shade_plain(bn, d, hit, albedo, bg, cfg, alive=alive, rad=rad,
                           tp_b=tp_b)
    _, shade_fn, err = _lib()
    consts = [float(x) for x in albedo] + [float(x) for x in bg]
    consts += ([float(x) for x in tp_b] if tp_b is not None else [1.0] * 3)
    consts += _light_scales(cfg)
    rad_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty_like(rad_out)
    with torch.cuda.device(dev):
        rc = shade_fn(n, bn.data_ptr(), d.data_ptr(), hit.data_ptr(),
                      _ptr(alive), _ptr(rad), rad_out.data_ptr(),
                      nrm.data_ptr(), (ctypes.c_float * 13)(*consts),
                      _stream(dev))
    _raise(rc, "pt_shade", err)
    LAUNCHES["pt_shade"] += 1
    return rad_out, nrm
