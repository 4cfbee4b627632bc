"""Image agreement gate between two renders of one frame.

The two-tier pixel gate of the JAX package's benchmark (bench.py
diff_metrics and its budgets): a noise tier counts pixels whose largest
channel differs by more than 4/255 (one visible u8 step), a big tier
those that differ by more than 0.25 (a different surface or a miss).
Epsilon flips at leaf silhouettes land in the noise tier in small
numbers; a miscompiled or wrong walk shows hundreds of big diffs.
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
