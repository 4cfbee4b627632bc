"""Debug-mode rendering — the sanitizer / D3D12-debug-layer analog.

The reference's only runtime checking was the D3D12 debug layer with
break-on-error (SURVEY §5, src/application.cpp:275-303). The JAX package
renders under `checkify`; here the same frame is rendered through the
kernel-free backends with explicit checks between the stages, so a bad
scene table or a numerical blow-up fails loudly with the stage's name
instead of rendering garbage:

  * the scene tables the frame reads are finite;
  * the prologue's ray matrix, frusta and per-frame table (tile backend)
    or the rays (per-ray backend) are finite;
  * each window's candidate units lie in [0, U), and its running t and
    normals (each chunk's, per-ray) are finite;
  * the image is finite.

A non-finite tensor raises FloatingPointError, an index out of range
IndexError. Each check reads one scalar back: this is a debug render,
not a timed one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from ..ops import tiled
from ..render import renderer

# Scene tables each backend reads. leaf_verts is checked on the tile
# backend too: every unit table it reads was built from it.
_RAY_TABLES = ("aabb_min", "aabb_max", "plane_t", "plane_b", "plane_n",
               "plane_o", "node_verts", "node_minmax", "leaf_verts")
_TILE_TABLES = ("cluster_aabb_min", "cluster_aabb_max", "unit_aabb_min",
                "unit_aabb_max", "unit_qn", "unit_n", "unit_e2w2",
                "unit_nrm", "unit_grid", "leaf_verts")


def check(stage: str, x: torch.Tensor, bound: int | None = None) -> None:
    """Raise unless x is finite (bound None) or every entry lies in
    [0, bound) (an index tensor)."""
    if bound is None:
        bad = int((~torch.isfinite(x)).sum())
        if bad:
            raise FloatingPointError(
                f"{stage}: {bad} non-finite value(s) of {x.numel()}")
        return
    lo, hi = int(x.min()), int(x.max())
    if lo < 0 or hi >= bound:
        raise IndexError(f"{stage}: indices span [{lo}, {hi}], outside "
                         f"[0, {bound})")


def debug_render(scene: DeviceScene, inv_view_proj, cfg: RenderConfig):
    """Render one frame with NaN/Inf and index checking.

    Returns the (H, W, 3) image; raises FloatingPointError (IndexError)
    naming the first stage whose tensor is not finite (out of range).
    "auto" and "pallas" render through the XLA tile backend, as the JAX
    package's checkified render does; "ray" through the per-ray backend.
    """
    pipeline = ("tile" if cfg.pipeline in ("auto", "pallas")
                else cfg.pipeline)
    # debug_guards: guard the production path's intentionally unguarded
    # Möller-Trumbore reciprocal, so the checks stay silent on clean
    # scenes and fire only on genuine NaN/Inf in the data (see
    # ops/tiled.py::trace_candidate).
    cfg = dataclasses.replace(cfg, pipeline=pipeline, debug_guards=True)
    for name in (_TILE_TABLES if pipeline == "tile" else _RAY_TABLES):
        table = getattr(scene, name)
        if table is not None:
            check(f"scene: {name}", table)
    if pipeline == "tile":
        img = tiled.render_tiled(scene, inv_view_proj, cfg, check=check)
    else:
        img = renderer.render_ray(scene, inv_view_proj, cfg, check=check)
    check("image", img)
    return img
