"""Reference pixels: the primary frame and the path tracer, pixel by pixel
from the oracle (raycast.py), the camera (camera.py), the shading
(shading.py) and the draw (threefry.py).

Both take a list of pixels, each with its frame's inverse view-projection,
and return their u8 colours (the path tracer also which of them a bounce
ray hit the mesh again in); the caster's dtype is the precision every
step runs in.
"""
from __future__ import annotations

import torch

from . import camera, shading, threefry
from .raycast import RayCaster


def primary_pixels(caster: RayCaster, ivps, px, py, width: int,
                   height: int) -> torch.Tensor:
    """(n, 3) u8 colours of pixels (px, py) of the frames whose matrices
    are ivps (n, 4, 4): the nearest hit's geometric normal, normalised,
    shaded toward the eye; the miss colour elsewhere."""
    dt = caster.dtype
    o, d = camera.primary_rays(ivps.to(caster.device), px.to(caster.device),
                               py.to(caster.device), width, height, dt)
    _, hit, n = caster.cast(o, d, shading.T_MIN, shading.T_MAX)
    n = n / torch.clamp_min(torch.sqrt((n * n).sum(-1, keepdim=True)), 1e-20)
    return shading.quantize(shading.ggx_shade(n, -d, hit))


def _cast_live(caster: RayCaster, o, d, alive):
    """caster.cast of the live rays alone: (t, hit, normal) with a miss
    (t = +inf, normal 0) on dead lanes."""
    t = torch.full(alive.shape, float("inf"), dtype=caster.dtype,
                   device=caster.device)
    hit = torch.zeros_like(alive)
    n = torch.zeros_like(o)
    live = alive.nonzero().squeeze(1)
    if live.numel():
        t[live], hit[live], n[live] = caster.cast(o[live], d[live],
                                                  shading.T_MIN,
                                                  shading.T_MAX)
    return t, hit, n


def pathtrace_pixels(caster: RayCaster, ivps, px, py, width: int,
                     height: int, spp: int, bounces: int, seed: int,
                     total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """((n, 3) u8 colours, (n,) bool rehit) of path-traced pixels
    (px, py), rehit where some sample's bounce ray hit the mesh again.
    A colour is the primary hit's direct light (the miss colour on a
    miss) plus the mean over `spp` samples of each bounce's gain,
    throughput albedo ** bounce: the miss colour where a live ray
    escapes, direct light where it hits. A hit spawns from its point,
    lifted 1e-4 along the normal facing the ray, a cosine-weighted
    direction drawn for lane sample * total + pixel."""
    dev, dt = caster.device, caster.dtype
    o0, d0 = camera.primary_rays(ivps.to(dev), px.to(dev), py.to(dev),
                                 width, height, dt)
    t0, hit0, n0 = caster.cast(o0, d0, shading.T_MIN, shading.T_MAX)
    nrm0 = shading.face_toward(n0, d0)
    zero = torch.zeros((), dtype=dt, device=dev)
    image = torch.where(hit0[:, None], shading.direct_light(nrm0),
                        shading.background(nrm0))
    origin0 = o0 + torch.where(hit0, t0, zero)[:, None] * d0 \
        + shading.BOUNCE_OFFSET * nrm0
    pixel = (py.to(dev) * width + px.to(dev)).to(torch.int64)
    gain = torch.zeros_like(image)
    rehit = torch.zeros_like(hit0)
    for s in range(spp):
        lane = s * total + pixel
        u = threefry.draw(seed, 0, lane, total).to(dt)
        d = torch.where(hit0[:, None], shading.cosine_dir(u, nrm0), d0)
        o, alive = origin0, hit0
        rad = torch.zeros_like(image)
        for b in range(1, bounces + 1):
            t, hit, n = _cast_live(caster, o, d, alive)
            rehit = rehit | hit
            nrm = shading.face_toward(n, d)
            tp = shading.albedo_power(b, rad)
            rad = rad + torch.where((alive & ~hit)[:, None],
                                    tp * shading.background(rad), zero)
            rad = rad + torch.where(hit[:, None],
                                    tp * shading.direct_light(nrm), zero)
            if b < bounces:
                u = threefry.draw(seed, b, lane, total).to(dt)
                o = o + torch.where(hit, t, zero)[:, None] * d \
                    + shading.BOUNCE_OFFSET * nrm
                d = torch.where(hit[:, None], shading.cosine_dir(u, nrm), d)
            alive = hit
        gain = gain + rad
    return shading.quantize(image + gain / spp), rehit
