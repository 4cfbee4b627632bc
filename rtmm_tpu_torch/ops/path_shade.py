"""The path tracer's per-lane work outside the trace: one kernel for the
primaries (pt_primary) and one per bounce (pt_bounce).

On the TPU this is XLA-fused device code inside the JAX package's jitted
path_trace (rtmm_tpu/render/pathtrace.py: the primaries' shading
:265-267, bounce origin :279 and spawn :364-372; rand2 :342-350; the
bounce lines :472-487); here it is two hand-written kernels,
csrc/path_shade.cu, each one of those fused regions.

  primary / primary_plain  the primaries: the normal normalised and
                           flipped toward the ray, the radiance
                           where(hit, direct, bg), the bounce origin and,
                           over spp x total lanes g = s * total + p, the
                           draw and the cosine-weighted next ray (pad
                           pixels p >= n dead).
  bounce / bounce_plain    one bounce of the sorted state: hit = alive &
                           (t < BIG) & (t > 0), the normal read in place,
                           the radiance gained (background on escaped
                           lanes, direct light on hits, times albedo ** b)
                           and, unless it is the last bounce, the draw
                           and the next ray.
  shading_consts(cfg)      a RenderConfig's shading constants, packed
                           once for the kernels.
  spawn_plain, shade_plain, rand2, cosine_dir, normalize_flip,
  direct_light             the plain pieces the two are composed of.
  LAUNCHES                 kernel launches so far (a view of the
                           counters in utils/spans.py).

The wrappers take the kernel for CUDA tensors (building it on first use;
a failed build or launch raises) and the plain version for CPU tensors.
The plain versions are the path tracer's eager expressions; the kernels
do the same float32 operations in the same order, so the two agree bit
for bit on the card.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..utils import spans, threefry
from . import culling, shading
from .tile_trace import _check

KERNELS = ("pt_primary", "pt_bounce")
LAUNCHES = spans.LaunchView(KERNELS)
BIG = 1e30


def reset_launches() -> None:
    LAUNCHES.reset()


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


def albedo_power(albedo: np.ndarray, bounce: int) -> np.ndarray:
    """albedo ** bounce in float32 by binary exponentiation, the product
    order of jax.lax.integer_pow (x**3 = x * (x * x))."""
    acc, x, y = None, albedo.astype(np.float32), bounce
    while y > 0:
        if y & 1:
            acc = x if acc is None else (acc * x).astype(np.float32)
        y >>= 1
        if y > 0:
            x = (x * x).astype(np.float32)
    return np.ones(3, np.float32) if acc is None else acc


def spawn_plain(seed: int, bounce: int, total: int, nrm, hit, o, d, *,
                idx=None, t=None, lanes=None, with_u=False):
    """The next rays of a bounce: per lane g the randoms u =
    uniform(fold_in(fold_in(fold_in(key(seed), bounce), g // total),
    g % total), (2,)) and the cosine-weighted direction around its normal.

    Bounce form (idx and t given): nrm (n, 3), hit (n,) bool, o, d (n, 3)
    and t (n,) are the n lanes of the sorted state, idx (n,) int32 their
    global lanes g; returns o + where(hit, t, 0) d + 1e-4 nrm and
    where(hit, dir, d). Primary form (lanes given, a multiple of total):
    nrm, hit, o (the bounce origins) and d of the n <= total primaries;
    lane g reads pixel g % total (pad lanes past n: nrm 0, hit False, o 0,
    d 1.0) and returns o and where(hit, dir, d) over the lanes. Returns
    (o, d), and the (lanes, 2) uniforms last when with_u."""
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
    """Shading of n lanes: bn (n, 3) the trace's unnormalised normals, d
    (n, 3) the rays, hit (n,) bool; albedo, bg float32 (3,) arrays.

    Bounce form (rad given, with alive (n,) bool and the throughput tp_b,
    a float32 (3,) array): rad + where(alive & ~hit, tp_b bg, 0) +
    where(hit, tp_b direct, 0). Primary form (rad None): where(hit,
    direct, bg). Returns (rad, nrm): float32 (n, 3), nrm the normal
    normalised and flipped toward the ray."""
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


def primary_plain(seed: int, total: int, spp: int, bn, d, o, t, hit,
                  sc: "Shading", *, with_u=False):
    """Plain version of pt_primary (same arguments and returns as
    primary): shade_plain's primary form, the bounce origin (o + t d) +
    1e-4 nrm, alive as hit padded and tiled over the samples, and
    spawn_plain's primary form."""
    rad0, nrm0 = shade_plain(bn, d, hit, sc.albedo, sc.bg, sc.cfg)
    borigin0 = o + t[:, None] * d + 1e-4 * nrm0
    pad = total - hit.shape[0]
    alive = torch.cat([hit, torch.zeros(pad, dtype=torch.bool,
                                        device=hit.device)]).repeat(spp)
    out = spawn_plain(seed, 0, total, nrm0, hit, borigin0, d,
                      lanes=spp * total, with_u=with_u)
    return (rad0, out[0], out[1], alive) + tuple(out[2:])


def bounce_plain(seed: int, bounce: int, total: int, bn, d, o, t, alive,
                 rad, idx, sc: "Shading", *, hit=None, spawn=True,
                 with_u=False):
    """Plain version of pt_bounce (same arguments and returns as bounce):
    the hit mask, shade_plain's bounce form with the throughput
    albedo ** bounce and, with spawn, spawn_plain's bounce form."""
    bn = bn.reshape(-1, 3)
    if hit is None:
        hit = alive & (t < BIG) & (t > 0.0)
    else:
        hit = alive & hit
    rad, nrm = shade_plain(bn, d, hit, sc.albedo, sc.bg, sc.cfg, alive=alive,
                           rad=rad, tp_b=sc.tp(bounce))
    if not spawn:
        return rad, hit
    return (rad, hit) + tuple(spawn_plain(seed, bounce, total, nrm, hit, o,
                                          d, idx=idx, t=t, with_u=with_u))


# ----------------------------------------------------------------------
# Constants and kernel wrappers.

class Shading:
    """The shading constants of one RenderConfig: albedo and background
    (float32 (3,) arrays), the config (its lights) and, per bounce b, the
    throughput albedo ** b and the 13 floats the kernels take (albedo,
    background, albedo ** b, each light's intensity x scale / pi), built
    once."""

    def __init__(self, cfg: RenderConfig):
        self.cfg = cfg
        self.albedo = np.asarray(cfg.mesh_color, np.float32)
        self.bg = np.asarray(cfg.background, np.float32)
        # A Python double per light; both versions round it to float32.
        self._scales = [cfg.light_intensity * s / np.pi
                        for s in shading.LIGHT_SCALE]
        self._tp: dict[int, np.ndarray] = {}
        self._packed: dict[int, ctypes.Array] = {}

    def tp(self, bounce: int) -> np.ndarray:
        if bounce not in self._tp:
            self._tp[bounce] = albedo_power(self.albedo, bounce)
        return self._tp[bounce]

    def packed(self, bounce: int) -> ctypes.Array:
        if bounce not in self._packed:
            vals = [*self.albedo.tolist(), *self.bg.tolist(),
                    *self.tp(bounce).tolist(), *self._scales]
            self._packed[bounce] = (ctypes.c_float * 13)(*vals)
        return self._packed[bounce]


@functools.lru_cache(maxsize=16)
def shading_consts(cfg: RenderConfig) -> Shading:
    """cfg's Shading, one per config."""
    return Shading(cfg)


@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build
    lib = _build.load("path_shade")
    vp, ci, cu, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_longlong)
    fp = ctypes.POINTER(ctypes.c_float)
    primary_fn = lib.rtmm_pt_primary
    primary_fn.argtypes = [ci] * 3 + [cu] * 2 + [vp] * 5 + [fp] + [vp] * 6
    primary_fn.restype = ci
    bounce_fn = lib.rtmm_pt_bounce
    bounce_fn.argtypes = ([ci] * 3 + [cu] * 2 + [vp, ci] + [cll] * 3
                          + [vp] * 7 + [fp] + [vp] * 6)
    bounce_fn.restype = ci
    empty_fn = lib.rtmm_pt_empty
    empty_fn.argtypes = [ci, vp]
    empty_fn.restype = ci
    err = lib.rtmm_pt_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return primary_fn, bounce_fn, empty_fn, err


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


def _normal_view(bn, n: int) -> tuple[int, int, int, int]:
    """The kernel's view of the trace's normals: (shift, outer, inner,
    component element strides) of bn as (g, 2 ** shift, 3). Takes (n, 3)
    and (g, G, 3) with g * G = n and G a power of two, any strides: K2's
    (g, 3, GROUP) buffer transposed, or dense rows."""
    if bn.dtype != torch.float32:
        raise TypeError(f"bn has dtype {bn.dtype}, expected torch.float32")
    shape = tuple(bn.shape)
    if shape == (n, 3):
        return 0, bn.stride(0), 0, bn.stride(1)
    if (len(shape) == 3 and shape[2] == 3 and shape[0] * shape[1] == n
            and shape[1] > 0 and shape[1] & (shape[1] - 1) == 0):
        return (shape[1].bit_length() - 1, bn.stride(0), bn.stride(1),
                bn.stride(2))
    raise ValueError(f"bn has shape {shape}, expected ({n}, 3) or (g, G, 3) "
                     f"with g * G = {n} and G a power of two")


def _raise(rc: int, name: str, err) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + err(rc).decode())


def _call(dev, fn, *args) -> int:
    """fn(*args, stream) on dev's current stream, switching the current
    device only when it is not dev. The raw stream handle builds no
    torch.cuda.Stream object on each call."""
    index = dev.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _ptr(x):
    return None if x is None else x.data_ptr()


def primary(seed: int, total: int, spp: int, bn, d, o, t, hit,
            sc: Shading, *, with_u=False):
    """The primaries' shading and first spawn, one launch.

    bn, d, o (n, 3) float32 (the trace's unnormalised normals, the rays),
    t (n,) float32 and hit (n,) bool of the n <= total pixels; sc the
    config's Shading. Per pixel the normal normalised and flipped toward
    the ray, the radiance where(hit, direct, bg) and the bounce origin
    (o + t d) + 1e-4 nrm; per lane g = s * total + p (s < spp, p < total)
    the randoms of bounce 0 and the next ray: o the bounce origin, d
    where(hit, dir, d), alive hit; pad lanes (p >= n) o 0, d 1.0, dead.

    Returns (rad0 (n, 3), o, d (spp * total, 3), alive (spp * total,)
    bool), and the (spp * total, 2) uniforms last when with_u (drawn on
    every lane). CUDA tensors launch pt_primary (csrc/path_shade.cu); CPU
    tensors run primary_plain."""
    with spans.span("rtmm.path_shade.primary"):
        n = hit.shape[0]
        for name, x in (("bn", bn), ("d", d), ("o", o)):
            _check(name, x, torch.float32, (n, 3))
        _check("t", t, torch.float32, (n,))
        _check("hit", hit, torch.bool, (n,))
        if n > total or spp < 0:
            raise ValueError(f"primary takes n <= total and spp >= 0 (n {n}, "
                             f"total {total}, spp {spp})")
        dev = hit.device
        _same_device(dev, bn=bn, d=d, o=o, t=t)
        if dev.type == "cpu":
            return primary_plain(seed, total, spp, bn, d, o, t, hit, sc,
                                 with_u=with_u)
        primary_fn, _, _, err = _lib()
        lanes = spp * total
        rad0 = torch.empty((n, 3), dtype=torch.float32, device=dev)
        # One allocation for o and d: each empty() is host time.
        o_out, d_out = torch.empty((2, lanes, 3), dtype=torch.float32,
                                   device=dev)
        alive = torch.empty(lanes, dtype=torch.bool, device=dev)
        u = (torch.empty((lanes, 2), dtype=torch.float32, device=dev)
             if with_u else None)
        kb0, kb1 = _bounce_key(seed, 0)
        rc = _call(dev, primary_fn, n, total, spp, kb0, kb1, bn.data_ptr(),
                   d.data_ptr(), o.data_ptr(), t.data_ptr(), hit.data_ptr(),
                   sc.packed(0), rad0.data_ptr(), o_out.data_ptr(),
                   d_out.data_ptr(), alive.data_ptr(), _ptr(u))
        _raise(rc, "pt_primary", err)
        if n or lanes:
            spans.launch("pt_primary")
        out = (rad0, o_out, d_out, alive)
        return out + (u,) if with_u else out


def bounce(seed: int, bounce: int, total: int, bn, d, o, t, alive, rad,
           idx, sc: Shading, *, hit=None, spawn=True, with_u=False):
    """One bounce of the sorted state's n lanes, one launch.

    bn the trace's unnormalised normals, (n, 3) or (g, G, 3) with any
    strides (read in place); d, o, rad (n, 3) float32, t (n,) float32
    (BIG where the ray missed), alive (n,) bool, idx (n,) int32 the
    lanes' global index g = sample * total + pixel; sc the config's
    Shading. hit = alive & (t < BIG) & (t > 0), or alive & hit when a hit
    mask is given (the per-ray engine's). Returns rad + where(alive &
    ~hit, tp bg, 0) + where(hit, tp direct, 0) (tp = albedo ** bounce)
    and hit; with spawn also the next rays o + where(hit, t, 0) d + 1e-4
    nrm and where(hit, dir, d) (the randoms of `bounce`, drawn on hits),
    and the (n, 2) uniforms last when with_u (drawn on every lane). o and
    idx are read only with spawn. CUDA tensors launch pt_bounce
    (csrc/path_shade.cu); CPU tensors run bounce_plain."""
    with spans.span("rtmm.path_shade.bounce"):
        n = alive.shape[0]
        _check("alive", alive, torch.bool, (n,))
        _check("t", t, torch.float32, (n,))
        for name, x in (("d", d), ("rad", rad)) + (
                (("o", o),) if spawn else ()):
            _check(name, x, torch.float32, (n, 3))
        if spawn:
            _check("idx", idx, torch.int32, (n,))
        elif with_u:
            raise ValueError("the uniforms are drawn only with spawn")
        if hit is not None:
            _check("hit", hit, torch.bool, (n,))
        view = _normal_view(bn, n)
        dev = alive.device
        _same_device(dev, bn=bn, d=d, t=t, rad=rad, hit=hit,
                     **({"o": o, "idx": idx} if spawn else {}))
        if dev.type == "cpu":
            return bounce_plain(seed, bounce, total, bn, d, o, t, alive, rad,
                                idx, sc, hit=hit, spawn=spawn, with_u=with_u)
        _, bounce_fn, _, err = _lib()
        hit_out = torch.empty(n, dtype=torch.bool, device=dev)
        o_out = d_out = u = None
        if spawn:
            # One allocation for rad, o and d: each empty() is host time.
            rad_out, o_out, d_out = torch.empty((3, n, 3), dtype=torch.float32,
                                                device=dev)
            if with_u:
                u = torch.empty((n, 2), dtype=torch.float32, device=dev)
        else:
            rad_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        kb0, kb1 = _bounce_key(seed, bounce)
        rc = _call(dev, bounce_fn, n, total, int(spawn), kb0, kb1,
                   bn.data_ptr(), *view, d.data_ptr(),
                   _ptr(o) if spawn else None, t.data_ptr(), alive.data_ptr(),
                   _ptr(hit), rad.data_ptr(), _ptr(idx) if spawn else None,
                   sc.packed(bounce), rad_out.data_ptr(), hit_out.data_ptr(),
                   _ptr(o_out), _ptr(d_out), _ptr(u))
        _raise(rc, "pt_bounce", err)
        if n:
            spans.launch("pt_bounce")
        if not spawn:
            return rad_out, hit_out
        out = (rad_out, hit_out, o_out, d_out)
        return out + (u,) if with_u else out


def empty_launch(dev, blocks: int) -> None:
    """An empty kernel of `blocks` 256-thread blocks on dev's current
    stream, launched as the kernels are: the launch floor beside their
    times. Not counted in LAUNCHES."""
    _, _, empty_fn, err = _lib()
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _raise(_call(dev, empty_fn, blocks), "pt_empty", err)
