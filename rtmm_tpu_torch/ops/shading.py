"""Cook-Torrance GGX shading + miss (ports shaders/closesthit.hlsl and
shaders/miss.hlsl).

Four hard-coded directional lights (+Z, +Y, -Z, -Y at intensity 22/11/22/11),
Reinhard tone map, albedo lerp — constants from closesthit.hlsl:1-9, main
loop from closesthit.hlsl:56-116. Pure element-wise float32 math; the trace
kernel's epilogue (csrc/tile_trace.cu, shade_rows there) repeats
shade_rows operation for operation.
"""
from __future__ import annotations

import torch

from ..config import RenderConfig
from . import _f32

PI = 3.14159265359

LIGHT_DIRS = (
    (0.0, 0.0, 1.0),
    (0.0, 1.0, 0.0),
    (0.0, 0.0, -1.0),
    (0.0, -1.0, 0.0),
)
LIGHT_SCALE = (1.0, 0.5, 1.0, 0.5)   # closesthit.hlsl:74-79


def _vec3(t, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([float(t[0]), float(t[1]), float(t[2])],
                        dtype=torch.float32, device=like.device)


def _pow5(x: torch.Tensor) -> torch.Tensor:
    """x ** 5 by the square-and-multiply of jax.lax.integer_pow:
    x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def _distribution_ggx(n_dot_h, roughness):
    a2 = (roughness * roughness) ** 2
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return _f32.rdiv(a2, PI * denom * denom)


def _geometry_schlick_ggx(n_dot, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return n_dot / (n_dot * (1.0 - k) + k)


def _fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - cos_theta, 0.0, 1.0))


def shade(normal: torch.Tensor, view: torch.Tensor,
          cfg: RenderConfig) -> torch.Tensor:
    """Shade hits. normal/view: (..., 3) -> color (..., 3)."""
    albedo = _vec3(cfg.mesh_color, normal)
    f0 = _vec3((0.04, 0.04, 0.04), normal)
    f0 = f0 + (albedo - f0) * cfg.metallic          # lerp(F0, albedo, metallic)

    n = normal
    v = view
    n_dot_v = torch.clamp_min((n * v).sum(-1), 0.0)
    ggx_v = _geometry_schlick_ggx(n_dot_v, cfg.roughness)

    lo = torch.zeros(n.shape[:-1] + (3,), dtype=torch.float32,
                     device=n.device)
    for ldir, lscale in zip(LIGHT_DIRS, LIGHT_SCALE):
        l = _vec3(ldir, n)
        h = v + l
        h = h / torch.clamp_min(torch.sqrt((h * h).sum(-1, keepdim=True)),
                                1e-20)
        radiance = _vec3(cfg.light_color, n) * (cfg.light_intensity * lscale)
        n_dot_l = torch.clamp_min((n * l).sum(-1), 0.0)
        ndf = _distribution_ggx(torch.clamp_min((n * h).sum(-1), 0.0),
                                cfg.roughness)
        g = ggx_v * _geometry_schlick_ggx(n_dot_l, cfg.roughness)
        f = _fresnel_schlick(torch.clamp_min((h * v).sum(-1), 0.0)[..., None],
                             f0)
        k_d = (1.0 - f) * (1.0 - cfg.metallic)
        numerator = (ndf * g)[..., None] * f
        denominator = 4.0 * n_dot_v * n_dot_l + 0.0001
        specular = numerator / denominator[..., None]
        lo = lo + ((_f32.div(k_d * albedo, PI) + specular)
                   * radiance * n_dot_l[..., None])

    ambient = albedo * (cfg.ambient_occlusion * cfg.light_intensity * 0.1)
    color = ambient + lo
    color = color / (color + 1.0)                   # Reinhard, closesthit.hlsl:111
    return albedo + (color - albedo) * cfg.shading_weight


def shade_or_miss(hit: torch.Tensor, normal: torch.Tensor,
                  view: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    bg = _vec3(cfg.background, normal)
    color = shade(normal, view, cfg)
    return torch.where(hit[..., None], color, bg)


def shade_rows(nx, ny, nz, vx, vy, vz, hit, cfg: RenderConfig):
    """Row-major shade_or_miss, the form of the trace kernel's epilogue.

    All inputs are same-shaped tensors (component rows); colors come back
    as (r, g, b) rows. Python-float constants round to float32 where they
    meet a tensor — exactly the same math as shade()/shade_or_miss().
    """
    alb = [float(c) for c in cfg.mesh_color]
    f0 = [0.04 + (a - 0.04) * cfg.metallic for a in alb]
    n_dot_v = torch.clamp_min(nx * vx + ny * vy + nz * vz, 0.0)
    ggx_v = _geometry_schlick_ggx(n_dot_v, cfg.roughness)

    lo = [torch.zeros_like(nx) for _ in range(3)]
    for ldir, lscale in zip(LIGHT_DIRS, LIGHT_SCALE):
        lx, ly, lz = ldir
        hx, hy, hz = vx + lx, vy + ly, vz + lz
        hnorm = torch.clamp_min(torch.sqrt(hx * hx + hy * hy + hz * hz),
                                1e-20)
        hx, hy, hz = hx / hnorm, hy / hnorm, hz / hnorm
        n_dot_l = torch.clamp_min(nx * lx + ny * ly + nz * lz, 0.0)
        ndf = _distribution_ggx(
            torch.clamp_min(nx * hx + ny * hy + nz * hz, 0.0), cfg.roughness)
        g = ggx_v * _geometry_schlick_ggx(n_dot_l, cfg.roughness)
        h_dot_v = torch.clamp_min(hx * vx + hy * vy + hz * vz, 0.0)
        fres5 = _pow5(torch.clamp(1.0 - h_dot_v, 0.0, 1.0))
        denom = 4.0 * n_dot_v * n_dot_l + 0.0001
        ndf_g = ndf * g
        for c in range(3):
            radiance = (cfg.light_color[c] * cfg.light_intensity * lscale)
            f_c = f0[c] + (1.0 - f0[c]) * fres5
            k_d = (1.0 - f_c) * (1.0 - cfg.metallic)
            spec = ndf_g * f_c / denom
            lo[c] = lo[c] + ((k_d * (alb[c] / PI) + spec)
                             * radiance * n_dot_l)

    out = []
    for c in range(3):
        ambient = alb[c] * (cfg.ambient_occlusion * cfg.light_intensity * 0.1)
        color = ambient + lo[c]
        color = color / (color + 1.0)               # Reinhard
        color = alb[c] + (color - alb[c]) * cfg.shading_weight
        out.append(torch.where(hit, color,
                               _f32.const(cfg.background[c], color)))
    return out
