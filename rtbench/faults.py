"""Faults planted in the renderer under a cell's entry, to show that the
check of `correct` sees them. Not used by the benchmark's runs: the
tests (rtbench/tests/, on the CPU) and rtbench/calibrate.py (on the card,
at a cell's own size) plant them.

  stale          a step that returns its state unchanged: the entry's
                 first output handed back again
  half           half of the batch left out: the first half of a batch's
                 frames, or of a frame's rows, kept, the rest the miss
                 colour
  altered        an answer altered where it is produced: every colour of
                 the entry's output +0.02
  bounce_misses  (path tracer) the bounce trace reports every lane a miss
  draw_seed      (path tracer) the bounce draws take the sample seed + 1

plant(fault, entry, patch): `patch(obj, name, value)` sets an attribute
(pytest's monkeypatch.setattr, or a Patcher, which can undo).
"""
from __future__ import annotations

import torch

from .reference.shading import BACKGROUND

OUTPUT = ("stale", "half", "altered")
BOUNCE = ("bounce_misses", "draw_seed")


def for_entry(entry: str) -> tuple[str, ...]:
    """The faults a cell of this entry can have."""
    return OUTPUT + (BOUNCE if entry == "pathtrace" else ())


def _stale(out, state):
    return state.setdefault("first", out.clone())


def _half(out, state):
    out = out.clone()
    bg = torch.tensor(BACKGROUND, dtype=out.dtype, device=out.device)
    if out.dim() == 4 and out.shape[0] > 1:
        out[out.shape[0] // 2:] = bg
    else:
        out[..., out.shape[-3] // 2:, :, :] = bg
    return out


def _altered(out, state):
    return out + 0.02


OUTPUT_FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


def plant(fault: str, entry: str, patch) -> None:
    from rtmm_tpu_torch.ops import group_trace, grouped, path_shade, \
        tile_trace
    from rtmm_tpu_torch.render import pathtrace, renderer
    if fault not in for_entry(entry):
        raise ValueError(f"no fault {fault!r} for entry {entry!r}; one of "
                         f"{for_entry(entry)}")
    if fault in OUTPUT_FAULTS:
        fn, state = OUTPUT_FAULTS[fault], {}
        if entry == "orbit":
            orig = tile_trace.render_frames
            patch(tile_trace, "render_frames",
                  lambda *a, **k: fn(orig(*a, **k), state))
        elif entry == "viewer":
            orig = renderer.render_image
            patch(renderer, "render_image",
                  lambda *a, **k: fn(orig(*a, **k), state))
        else:
            orig = pathtrace.path_trace

            def traced(*a, **k):
                img, stats = orig(*a, **k)
                return fn(img, state), stats
            patch(pathtrace, "path_trace", traced)
    elif fault == "bounce_misses":
        for mod in (group_trace, grouped):
            def misses(*a, _orig=mod.trace_sorted, _big=mod.BIG, **k):
                bt, bn, ovf = _orig(*a, **k)
                return torch.full_like(bt, _big), bn, ovf
            patch(mod, "trace_sorted", misses)
    else:
        for name in ("primary", "bounce"):
            def shifted(seed, *a, _orig=getattr(path_shade, name), **k):
                return _orig(seed + 1, *a, **k)
            patch(path_shade, name, shifted)


class Patcher:
    """patch(obj, name, value) that remembers what it replaced; undo()
    puts it back."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)
