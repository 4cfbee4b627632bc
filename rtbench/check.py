"""How `correct` is decided: the renderer's u8 pixels from the window
against the plain reference's, at the window's sizes and cameras.

The numbers compared, over the sampled pixels of a run:

  px_over_2         the share of pixels whose largest channel gap
                    exceeds two u8 levels (a pixel that misses geometry
                    the reference hits, or hits it elsewhere, or a path
                    that diverged);
  mean_gap          the mean absolute channel gap in u8 levels;
  px_over_2.<s>     px_over_2 over a subset s of the pixels the driver's
                    reference names: "bounce", the path-traced pixels in
                    which a bounce ray of the reference hits the mesh
                    again (an escaping ray adds the constant miss colour
                    whatever its direction, so a fault of the bounce
                    trace, draw or spawn shows on these). 0 on an empty
                    subset.

A cell compares the numbers its checks/<workload>.json gives limits for,
each set from readings of sound runs (the lower) and of the control (the
upper): the reference computed in bfloat16 in the renderer's place
(control()).
"""
from __future__ import annotations

import torch

from .reference.raycast import RayCaster

NUMBERS = ("px_over_2", "mean_gap")


def numbers(got, want, subsets: dict | None = None) -> dict:
    """The numbers of u8 pixels `got` against `want` (n, 3), and of each
    subset (name -> (n,) bool mask) of them."""
    got = torch.as_tensor(got).to(torch.int32).cpu()
    want = torch.as_tensor(want).to(torch.int32).cpu()
    gap = (got - want).abs()
    over = gap.amax(-1) > 2 if gap.numel() else torch.zeros(0, dtype=bool)
    n = max(gap.shape[0], 1)
    out = {"px_over_2": float(over.sum()) / n,
           "mean_gap": float(gap.float().mean()) if gap.numel() else 0.0}
    for name, mask in (subsets or {}).items():
        mask = torch.as_tensor(mask).cpu()
        out[f"px_over_2.{name}"] = (float((over & mask).sum())
                                    / max(int(mask.sum()), 1))
    return out


def caster(arrays: dict, device, dtype=torch.float32) -> RayCaster:
    return RayCaster(arrays["vertices"], arrays["triangles"], device, dtype)


def judge(driver, drawn: dict, arrays: dict, device, limits: dict | None):
    """(correct, {name: (value, limit)}, reference pixels, the reference's
    subsets {name: (n,) bool}) of the drawn pixels: the numbers the
    limits name (every number when the cell has no limits yet, and then
    never correct)."""
    want, subsets = driver.reference_pixels(caster(arrays, device), drawn)
    got = numbers(drawn["values"], want, subsets)
    names = list(got) if limits is None else list(limits)
    table = {k: (got[k], None if limits is None else limits[k])
             for k in names}
    ok = limits is not None and all(v <= lim for v, lim in table.values())
    return ok, table, want, subsets


def control(driver, drawn: dict, arrays: dict, device, want, subsets,
            limits: dict | None = None) -> tuple[dict, bool]:
    """(numbers, judged correct) of the control: the reference in
    bfloat16 put in the renderer's place, against the float32 reference
    `want` and on its subsets."""
    low, _ = driver.reference_pixels(
        caster(arrays, device, torch.bfloat16), drawn)
    got = numbers(low, want, subsets)
    ok = limits is not None and all(got[k] <= v for k, v in limits.items())
    return got, ok
