"""Shading constants and formulas of the reference renderer, frozen.

Primary frames: Cook-Torrance GGX with four directional lights, Reinhard
tone map and the material colour (shaders/closesthit.hlsl:1-116), the
miss colour (shaders/miss.hlsl:7), u8 quantisation as the
R8G8B8A8_UNORM output texture (src/application.cpp:82-89). Path tracer:
Lambertian direct light from the same four lights, tone-mapped, the miss
colour as a constant environment, albedo ** bounce throughput and a
cosine-weighted hemisphere draw around the normal.
"""
from __future__ import annotations

import math

import torch

PI = 3.14159265359
LIGHT_DIRS = ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (0.0, 0.0, -1.0),
              (0.0, -1.0, 0.0))
LIGHT_SCALE = (1.0, 0.5, 1.0, 0.5)
LIGHT_INTENSITY = 22.0
ALBEDO = (0.51, 0.62, 0.82)
BACKGROUND = (0.29, 0.29, 0.29)
METALLIC, ROUGHNESS, AMBIENT_OCCLUSION = 0.25, 0.45, 0.1
T_MIN, T_MAX = 0.001, 10000.0
MT_UV_EPS = 1e-3          # intersection.hlsl:413
BOUNCE_OFFSET = 1e-4


def _vec(c, like):
    return torch.tensor(c, dtype=like.dtype, device=like.device)


def _ggx(n_dot, r):
    k = (r + 1.0) * (r + 1.0) / 8.0
    return n_dot / (n_dot * (1.0 - k) + k)


def ggx_shade(n: torch.Tensor, v: torch.Tensor, hit: torch.Tensor):
    """(n, 3) colours of unit normals n, v the unit direction toward the
    eye; the miss colour where not hit."""
    albedo = _vec(ALBEDO, n)
    f0 = 0.04 + (albedo - 0.04) * METALLIC
    n_dot_v = torch.clamp_min((n * v).sum(-1), 0.0)
    ggx_v = _ggx(n_dot_v, ROUGHNESS)
    a2 = (ROUGHNESS * ROUGHNESS) ** 2
    lo = torch.zeros_like(n)
    for ldir, scale in zip(LIGHT_DIRS, LIGHT_SCALE):
        l = _vec(ldir, n)
        h = v + l
        h = h / torch.clamp_min(torch.sqrt((h * h).sum(-1, keepdim=True)),
                                1e-20)
        n_dot_l = torch.clamp_min((n * l).sum(-1), 0.0)
        n_dot_h = torch.clamp_min((n * h).sum(-1), 0.0)
        denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
        ndf = a2 / (PI * denom * denom)
        g = ggx_v * _ggx(n_dot_l, ROUGHNESS)
        h_dot_v = torch.clamp_min((h * v).sum(-1), 0.0)
        f = f0 + (1.0 - f0) * torch.clamp(1.0 - h_dot_v, 0.0, 1.0)[
            :, None] ** 5
        k_d = (1.0 - f) * (1.0 - METALLIC)
        spec = (ndf * g)[:, None] * f / (4.0 * n_dot_v * n_dot_l
                                         + 0.0001)[:, None]
        lo = lo + (k_d * albedo / PI + spec) * (LIGHT_INTENSITY * scale) \
            * n_dot_l[:, None]
    color = albedo * (AMBIENT_OCCLUSION * LIGHT_INTENSITY * 0.1) + lo
    color = color / (color + 1.0)
    return torch.where(hit[:, None], color, _vec(BACKGROUND, n))


def direct_light(n: torch.Tensor) -> torch.Tensor:
    """(n, 3) Lambertian direct light on unit normals, tone-mapped."""
    albedo = _vec(ALBEDO, n)
    lo = torch.zeros_like(n)
    for ldir, scale in zip(LIGHT_DIRS, LIGHT_SCALE):
        n_dot_l = torch.clamp_min((n * _vec(ldir, n)).sum(-1), 0.0)
        lo = lo + albedo * (LIGHT_INTENSITY * scale / math.pi) \
            * n_dot_l[:, None]
    return lo / (lo + 1.0)


def face_toward(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Unit normals flipped against the ray direction d."""
    n = n / torch.clamp_min(torch.sqrt((n * n).sum(-1, keepdim=True)),
                            1e-20)
    return torch.where(((n * d).sum(-1) > 0.0)[:, None], -n, n)


def cosine_dir(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction around unit normals n from uniforms u
    (n, 2)."""
    r = torch.sqrt(u[:, 0])
    phi = (2.0 * math.pi) * u[:, 1]
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))
    up = torch.where((n[:, 2:3].abs() < 0.9), _vec((0.0, 0.0, 1.0), n),
                     _vec((1.0, 0.0, 0.0), n))
    t = torch.linalg.cross(up, n)
    t = t / torch.clamp_min(torch.sqrt((t * t).sum(-1, keepdim=True)), 1e-20)
    b = torch.linalg.cross(n, t)
    return x[:, None] * t + y[:, None] * b + z[:, None] * n


def albedo_power(bounce: int, like: torch.Tensor) -> torch.Tensor:
    return _vec(ALBEDO, like) ** bounce


def background(like: torch.Tensor) -> torch.Tensor:
    return _vec(BACKGROUND, like)


def quantize(img: torch.Tensor) -> torch.Tensor:
    """Colours in [0, 1] to u8, as the u8 output texture rounds them."""
    return (torch.clamp(img.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
