"""Render configuration.

The reference hard-codes all render/shading parameters as shader constants
(shaders/closesthit.hlsl:1-9, shaders/raygen.hlsl:35-36,
src/application.cpp:41-42). Here they are surfaced as a dataclass with the
reference values as defaults, so benchmarks and tests can tune them without
recompiling shaders.

Port note: this keeps the fields that define the reference semantics of
the frame and of the ported backends: `pipeline` ("auto" and "pallas" are
the hand-written tile kernel, on the CPU its plain version; "tile" is the
kernel-free XLA tile backend; "ray" the per-ray reference backend), that
backend's `max_candidates` and `ray_chunk`, the tile backend's
`clusters_per_window` and `tile_chunk`, and `debug_guards` (the
sanitizer render, utils/debug.py). Dropped from the JAX package's
RenderConfig, as TPU-only knobs: `tiles_per_block`, `mt_precision` (the
port computes in float32 throughout), `compute_dtype`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Window / dispatch size (src/application.cpp:41 — 1024x1024 window).
    width: int = 1024
    height: int = 1024

    # Camera (src/application.cpp:42 — perspective(radians(80), aspect, 0.1, 1000)).
    fov_y_degrees: float = 80.0
    near: float = 0.1
    far: float = 1000.0

    # Ray extents (shaders/raygen.hlsl:35-36).
    t_min: float = 0.001
    t_max: float = 10000.0

    # Miss/background color (shaders/miss.hlsl:7).
    background: tuple[float, float, float] = (0.29, 0.29, 0.29)

    # PBR material + lights (shaders/closesthit.hlsl:1-9).
    shading_weight: float = 1.0
    metallic: float = 0.25
    roughness: float = 0.45
    ambient_occlusion: float = 0.1
    mesh_color: tuple[float, float, float] = (0.51, 0.62, 0.82)
    light_color: tuple[float, float, float] = (1.0, 1.0, 1.0)
    light_intensity: float = 22.0

    # Trace backend: "auto" / "pallas" = the tile-trace kernel (its plain
    # version on the CPU); "tile" = the XLA tile backend (ops/tiled.py);
    # "ray" = the per-ray reference backend (ops/traversal.py).
    pipeline: str = "auto"
    # Per-ray backend: top-K candidate base triangles per ray, and rays
    # per chunk (render/renderer.py::_pick_chunk scales it down for deep
    # hierarchies to bound peak memory).
    max_candidates: int = 8
    ray_chunk: int = 16384
    # XLA tile backend: clusters consumed per candidate window (window
    # capacity = clusters_per_window * 64 units) and tiles per chunk.
    clusters_per_window: int = 4
    tile_chunk: int = 256

    # Per-tile cluster-list capacity of one trace launch. A scene with
    # more clusters is traced in windows of this many clusters (the
    # windowed kernel mode); 256 keeps a 200-cluster (51k-tri) scene on
    # the fused single-launch path.
    kernel_clusters_per_window: int = 256
    # Sub-cones per 32x32 tile for the kernel's per-unit cull. 4 (vertical
    # 8-px strips) for coherent primary frames; 8 for silhouette-heavy
    # frames.
    sub_frusta: int = 4
    # Rows in the sub-cone grid (1 = vertical strips). Must divide
    # sub_frusta and the 32-px tile height.
    sub_rows: int = 1
    # Generate primary rays inside the fused kernel from the inv-view-proj
    # scalars of the frustum pack; False reads them from a ray matrix
    # built by the prologue (as the windowed mode always does).
    kernel_raygen: bool = True

    # Two-level instancing (render/instances.py): tile rows per instance.
    # The serial scan gathers at most this many tiles of one instance
    # (0 = max(32, tiles // 8)); the merged launch sizes its one row pool
    # as instance_tile_cap * N (0 = tiles + 4 * N).
    instance_tile_cap: int = 0

    # Sanitizer mode (utils/debug.py, the D3D12-debug-layer analog): guard
    # the intentionally unguarded Möller-Trumbore reciprocal of the tile
    # backend so a checked render stays NaN/Inf-free on clean scenes and
    # only real data corruption fires. Production paths keep the
    # unguarded division (the acceptance window rejects the Inf/NaN lanes).
    debug_guards: bool = False


DEFAULT_CONFIG = RenderConfig()
