"""Image agreement gates between two renders of one frame.

The two-tier pixel gate of the JAX package's benchmark (bench.py
diff_metrics and its budgets): a noise tier counts pixels whose largest
channel differs by more than 4/255 (one visible u8 step), a big tier
those that differ by more than 0.25 (a different surface or a miss).
Epsilon flips at leaf silhouettes land in the noise tier in small
numbers; a miscompiled or wrong walk shows hundreds of big diffs.
Scenes with several leaves per pixel take the cell tier instead
(cell_gate), and verify_plan gives bench.py's verification size and mode.
"""
from __future__ import annotations

import torch


def image_gate(a: torch.Tensor, b: torch.Tensor, per: int = 2000,
               big_per: int = 50000, mask: torch.Tensor | None = None
               ) -> dict:
    """Compare two (H, W, 3) renders. Returns the counts, the budgets
    max(64, n // per) and max(16, n // big_per) for n = W*H pixels, the
    max pixel difference, and "ok" when both counts are within budget.
    The path tracer's gate (bench.py:583-584) takes per = big_per = 500:
    a bounce hit that flips at a leaf edge repaints its whole pixel.
    mask, an (H, W) bool, restricts the gate to its pixels (n = their
    count)."""
    d = (a.float() - b.float()).abs().amax(dim=-1)
    n = a.shape[0] * a.shape[1]
    if mask is not None:
        d = d[mask]
        n = d.numel()
    npix = int((d > 4.0 / 255.0).sum())
    nbig = int((d > 0.25).sum())
    budget = max(64, n // per)
    big_budget = max(16, n // big_per)
    return {"npix": npix, "nbig": nbig, "budget": budget,
            "big_budget": big_budget, "maxdiff": float(d.max()) if n else 0.0,
            "ok": npix <= budget and nbig <= big_budget}


# bench.py's cell tier (diff_metrics, main's cell branch): mean |diff| over
# CELL x CELL pixel cells of the frame cropped to whole cells; at most
# CELL_BUDGET cells over CELL_MAX, and at most a tenth of the pixels over
# 4/255 (a uniform small bias that the cell means alone would admit).
CELL = 6
CELL_MAX = 0.05
CELL_BUDGET = 8
# bench.py's verify sizes (_verify_image): frames of scenes with more
# valid units than these are verified at the reduced size.
VERIFY_SIZES = ((400_000, (240, 136)), (100_000, (480, 270)))


def cell_gate(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Compare two (H, W, 3) renders of a subpixel-leaf scene, where two
    correct single-sample renderers disagree on scattered pixels (a t tie
    flips which leaf of a pixel wins) and only a regional fault moves
    whole cells. Returns the cell counts and budget, the pixel counts
    and guard, and "ok"."""
    d = (a.float() - b.float()).abs()
    h, w = d.shape[0], d.shape[1]
    ch, cw = (h // CELL) * CELL, (w // CELL) * CELL
    cells = (d[:ch, :cw].mean(dim=-1)
             .reshape(ch // CELL, CELL, cw // CELL, CELL).mean(dim=(1, 3)))
    dmax = d.amax(dim=-1)
    ncell = int((cells > CELL_MAX).sum())
    npix = int((dmax > 4.0 / 255.0).sum())
    guard = max(h * w // 10, 1)
    return {"ncell": ncell, "maxcell": float(cells.max()) if cells.numel()
            else 0.0, "cell_budget": CELL_BUDGET, "npix": npix,
            "nbig": int((dmax > 0.25).sum()), "npix_guard": guard,
            "maxdiff": float(dmax.max()),
            "ok": ncell <= CELL_BUDGET and npix <= guard}


def verify_plan(n_units: int, width: int, height: int
                ) -> tuple[int, int, str]:
    """bench.py's verification of a frame of a scene with n_units valid
    units: (width, height, mode). Scenes above 10^5 / 4*10^5 units are
    verified at 480x270 / 240x136; the mode is "cell" (cell_gate) when
    the scene holds more than 4 leaves per verified pixel (64 per unit),
    else "pixel" (image_gate)."""
    vw, vh = width, height
    for above, size in VERIFY_SIZES:
        if n_units > above:
            vw, vh = size
            break
    return vw, vh, "cell" if n_units * 64 > 4 * vw * vh else "pixel"
