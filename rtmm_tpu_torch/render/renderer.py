"""Frame renderer: prologue -> fused trace + shade -> framebuffer.

Equivalent of the reference per-frame hot loop (Application::update,
src/application.cpp:200-242): there, one DispatchRays call renders the frame
into a UAV texture which is copied to the swapchain. Here one kernel launch
(ops/tile_trace.py) renders the frame after a short tensor prologue; the
only per-frame host->device input is the 4x4 inverse view-projection
matrix (application.cpp:204-205). Scenes with more clusters than one
launch's per-tile list holds render in cluster windows, one launch each.
The per-ray reference backend (pipeline "ray") and the XLA tile backend
("tile") render the same frame without the kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from ..ops import raygen, shading, tile_trace, tiled, traversal
from ..utils import spans


def render_image(scene: DeviceScene, inv_view_proj,
                 cfg: RenderConfig) -> torch.Tensor:
    """Render one frame on the scene's device. Returns (H, W, 3) float32
    in [0, 1]. cfg.pipeline "auto" / "pallas": the tile-trace kernel on the
    card (fused, or windowed for scenes over kernel_clusters_per_window
    clusters), its plain version on the CPU; "tile": the kernel-free XLA
    tile backend (ops/tiled.py); "ray": the per-ray reference backend
    (ops/traversal.py), in chunks of _pick_chunk rays."""
    if cfg.pipeline == "tile":
        return tiled.render_tiled(scene, inv_view_proj, cfg)
    if cfg.pipeline == "ray":
        return render_ray(scene, inv_view_proj, cfg)
    if cfg.pipeline not in ("auto", "pallas"):
        raise ValueError(f"unknown pipeline {cfg.pipeline!r}; one of "
                         "'auto', 'pallas', 'tile', 'ray'")
    return tile_trace.render_frame(scene, inv_view_proj, cfg)


def render_ray(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
               check=None) -> torch.Tensor:
    """The per-ray pipeline: raygen, then per chunk of rays the exact
    traversal and shade_or_miss (the JAX package's lax.map over chunks,
    as a host loop of launches with no sync). check(stage, tensor), when
    given (the sanitizer render, utils/debug.py), sees the rays and each
    chunk's t and normals."""
    height, width = cfg.height, cfg.width
    origins, directions = raygen.generate_rays(inv_view_proj, width, height,
                                               device=scene.device)
    if check is not None:
        check("raygen: origins", origins)
        check("raygen: directions", directions)
    total = height * width
    chunk = _pick_chunk(cfg, scene)
    colors = []
    for c0 in range(0, total, chunk):
        o, d = origins[c0:c0 + chunk], directions[c0:c0 + chunk]
        t, nrm, hit = traversal.trace(scene, o, d, cfg)
        if check is not None:
            check(f"rays {c0}-{c0 + o.shape[0] - 1}: t", t)
            check(f"rays {c0}-{c0 + o.shape[0] - 1}: normals", nrm)
        colors.append(shading.shade_or_miss(hit, nrm, -d, cfg))
    return torch.cat(colors).reshape(height, width, 3)


def _pick_chunk(cfg: RenderConfig, scene: DeviceScene) -> int:
    """Scale the ray chunk down for deep hierarchies to bound peak memory."""
    chunk = cfg.ray_chunk >> (2 * max(scene.max_level - 3, 0))
    return max(min(chunk, cfg.height * cfg.width), 256)


def _quantize(img: torch.Tensor) -> torch.Tensor:
    """On-device u8 quantization, as the reference's R8G8B8A8_UNORM output
    texture (src/application.cpp:82-89)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


class Renderer:
    """The render pipeline for one scene.

    Analog of Application's RayTraceShader setup (src/application.cpp:113-197);
    render() is the per-frame path. The kernel library is built on the
    first frame rendered on the card.
    """

    def __init__(self, scene: DeviceScene, cfg: RenderConfig | None = None):
        self.scene = scene
        self.cfg = cfg or RenderConfig()

    def resize(self, width: int, height: int) -> None:
        """New framebuffer size — the analog of the reference's WM_SIZE
        path (framework/src/window.cpp:173-182)."""
        self.cfg = dataclasses.replace(self.cfg, width=width, height=height)

    def render(self, inv_view_proj) -> torch.Tensor:
        """Returns the (H, W, 3) float32 framebuffer on the scene's device."""
        return render_image(self.scene, inv_view_proj, self.cfg)

    def render_u8_device(self, inv_view_proj) -> torch.Tensor:
        """(H, W, 3) uint8 frame, quantized on the scene's device."""
        return _quantize(self.render(inv_view_proj))

    def render_u8(self, inv_view_proj) -> np.ndarray:
        """Quantized frame as a host uint8 array (quantization runs on the
        device; only the u8 frame is read back)."""
        return self.render_u8_device(inv_view_proj).cpu().numpy()


class FramePipeline:
    """Two frames in flight — the GPUState swapchain-pacing analog
    (src/dx_util/GPUState.cpp:115-148 keeps 2 frames in flight and blocks
    on the fence of frame n-2).

    Kernel launches are asynchronous: submit() queues frame n on the
    current CUDA stream, starts its copy into pinned host memory and
    returns, so the device renders frame n while the host reads back and
    writes out frame n-1. On the CPU every frame completes in submit().
    """

    def __init__(self, renderer: Renderer, depth: int = 2):
        self.renderer = renderer
        self.depth = depth
        self._queue: list = []

    def submit(self, inv_view_proj):
        """Enqueue a frame; returns the oldest finished frame (as uint8
        ndarray) once the pipeline is full, else None. Spans: the call
        "rtmm.submit", its issue (render, quantise, copy, event)
        "rtmm.submit.issue" and its wait on frame n - depth's fence
        "rtmm.submit.fence_wait"."""
        with spans.span("rtmm.submit"):
            with spans.span("rtmm.submit.issue"):
                frame = self.renderer.render_u8_device(inv_view_proj)
                if frame.device.type == "cuda":
                    host = torch.empty(frame.shape, dtype=frame.dtype,
                                       pin_memory=True)
                    host.copy_(frame, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(frame.device))
                    self._queue.append((host, done))
                else:
                    self._queue.append((frame, None))
            if len(self._queue) >= self.depth:
                return self._pop()
            return None

    def _pop(self) -> np.ndarray:
        host, done = self._queue.pop(0)
        if done is not None:
            spans.sync("submit.fence_wait", done, torch.cuda.Event.synchronize)
        return host.numpy()

    def drain(self):
        """Yield all remaining frames."""
        while self._queue:
            yield self._pop()
