"""Per-frame observability (SURVEY §5: the reference has none — its only
instrumentation was the D3D12 debug layer and eyeballing frames).

Structured per-frame statistics: throughput, hit rate, candidate-list
distribution (the traversal-divergence proxy), the per-pixel traversal
step heatmap, plus a torch.profiler trace and the device's busy share
read from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..ops import raygen, tiled, traversal
from ..render.renderer import render_image
from . import spans


@dataclasses.dataclass
class FrameStats:
    frame_ms: float
    mrays_per_s: float
    hit_fraction: float
    tiles: int
    candidates_mean: float
    candidates_p90: float
    candidates_max: int
    empty_tiles: int
    traversal_steps_total: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def traversal_heatmap(scene, inv_view_proj, cfg) -> np.ndarray:
    """(H, W) int32 per-pixel traversal-step counts (SURVEY §5: the
    divergence heatmap the reference lacks) — hierarchy nodes surviving
    pruning plus leaf Möller-Trumbore tests, per ray, through the per-ray
    backend in chunks of max(cfg.ray_chunk, 256) rays."""
    h, w = cfg.height, cfg.width
    o, d = raygen.generate_rays(inv_view_proj, w, h, device=scene.device)
    total = h * w
    chunk = min(max(cfg.ray_chunk, 256), total)
    steps = [traversal.trace_with_steps(scene, o[c0:c0 + chunk],
                                        d[c0:c0 + chunk], cfg)[3]
             for c0 in range(0, total, chunk)]
    return torch.cat(steps).reshape(h, w).cpu().numpy()


def heatmap_to_png(path: str, counts: np.ndarray) -> None:
    """Dump a step-count heatmap as a viridis-ish PNG."""
    from ..io import image

    c = counts.astype(np.float64)
    hi = max(c.max(), 1.0)
    t = (c / hi)[..., None]
    # simple 3-stop gradient: black -> magenta -> yellow
    lo_c = np.array([0.0, 0.0, 0.05])
    mid_c = np.array([0.7, 0.1, 0.6])
    hi_c = np.array([1.0, 0.95, 0.3])
    img = np.where(t < 0.5, lo_c + (mid_c - lo_c) * (t * 2.0),
                   mid_c + (hi_c - mid_c) * ((t - 0.5) * 2.0))
    image.write_png(path, (img * 255.0 + 0.5).astype(np.uint8))


def _timed_ms(fn, device: torch.device):
    """(fn(), ms): CUDA events on the card, perf_counter on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def collect_frame_stats(scene, inv_view_proj, cfg,
                        heatmap: np.ndarray | None = None) -> FrameStats:
    """Render one frame with timing + traversal statistics.

    Pass a precomputed `traversal_heatmap` result to avoid re-running the
    per-ray reference trace (the slowest pipeline) twice per frame. The
    frame renders once untimed (the kernel build on the card), then once
    timed."""
    count = tiled.candidate_counts(scene, inv_view_proj, cfg).cpu().numpy()
    render_image(scene, inv_view_proj, cfg)
    img, ms = _timed_ms(lambda: render_image(scene, inv_view_proj, cfg),
                        scene.device)
    steps = (heatmap if heatmap is not None
             else traversal_heatmap(scene, inv_view_proj, cfg))

    img = img.cpu().numpy()
    bg = np.asarray(cfg.background, np.float32)
    hit_fraction = float((np.abs(img - bg).max(-1) > 1e-5).mean())
    n_rays = cfg.width * cfg.height
    return FrameStats(
        frame_ms=ms,
        mrays_per_s=n_rays / (ms * 1e-3) / 1e6,
        hit_fraction=hit_fraction,
        tiles=int(count.shape[0]),
        candidates_mean=float(count.mean()),
        candidates_p90=float(np.percentile(count, 90)),
        candidates_max=int(count.max()),
        empty_tiles=int((count == 0).sum()),
        traversal_steps_total=int(steps.sum()),
    )


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler trace of the block, CPU and (where there is a card)
    CUDA activity, written to logdir/trace.json (chrome://tracing or
    Perfetto), with the program's spans on (utils/spans.py), so the trace
    carries their ranges. Yields the profiler; device_busy(logdir) reads
    the device's busy share from the written trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, spans.on():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(logdir: str) -> dict:
    """The device's busy share of a profiler_trace window: the union of
    the device's kernel, copy and fill intervals over the span of every
    traced event (host and device). Returns {"window_us", "busy_us",
    "share", "kernels"}; share is None when the trace holds no device
    event."""
    with open(os.path.join(logdir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        return {"window_us": 0.0, "busy_us": 0.0, "share": None,
                "kernels": 0}
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    return {"window_us": hi - lo, "busy_us": busy,
            "share": busy / (hi - lo) if spans else None,
            "kernels": kernels}
