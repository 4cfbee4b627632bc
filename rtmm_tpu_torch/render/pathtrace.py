"""Path-traced multi-bounce rendering with ray compaction (bench config 5).

The reference is a primary-ray-only renderer; this extends the same
traversal to a Monte-Carlo path tracer:

  * a wavefront bounce loop over dense ray buffers (no recursion);
  * a Lambertian surface with the reference's material colour, lit by the
    reference's four directional lights plus the miss colour as a constant
    environment term;
  * cosine-weighted hemisphere sampling with randoms hashed from (seed,
    bounce, sample, pixel) (utils/threefry.py: jax.random's threefry, bit
    for bit), so a ray's randoms do not depend on the order rays are
    sorted in, and every engine renders the same image;
  * bounce 0 is the camera rays: coherent, so they ride the primary
    pipeline (the tile-trace kernel's raw mode, or the XLA tile backend)
    once per frame, their shading shared by every sample;
  * secondary bounces keep the per-ray state (origin, direction,
    radiance, lane index) in sorted order across bounces: each bounce pays
    one stable sort into direction-octant / origin-cell groups (dead rays
    sink to the back), and only the final radiance is un-permuted, once;
  * all samples ride one merged pipeline of spp x rays lanes; after a
    bounce's sort the state is cut to a per-bounce lane cap when the live
    rays fit it (the cut-off tail is dead and its radiance final), so
    later bounces pay for the live rays, not the buffer;
  * per lane, the shading, the draw and the next ray are one kernel
    launch for the primaries and one per bounce on a CUDA scene
    (ops/path_shade.py, csrc/path_shade.cu: pt_primary, pt_bounce), in
    every engine; their plain versions on a CPU scene.

Secondary engines: "pallas" = the grouped trace kernel (ops/group_trace.py,
csrc/group_trace.cu; its plain version on CPU tensors) with the tile
kernel's raw or windowed mode for the primaries; "grouped" = the
kernel-free engine (ops/grouped.py, with the XLA tile backend for the
primaries); "perray" = the per-ray reference backend (ops/traversal.py)
for the primaries and every bounce, with no lane caps; "auto" = pallas on
a CUDA scene, grouped on a CPU scene.

The JAX package's render/pathtrace.py is the reference. Its TPU A/B knob
RTMM_PT_HASHRAND (pre-drawn randoms) is not ported: the randoms are
always hash-drawn, its default.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import DeviceScene
from ..ops import (_f32, culling, group_trace, grouped, path_shade, raygen,
                   tile_trace, tiled, traversal)
from ..utils import spans

BIG = 1e30
GROUP = grouped.GROUP
ENGINES = ("auto", "pallas", "grouped", "perray")


@dataclasses.dataclass(frozen=True)
class PathTraceConfig:
    bounces: int = 3
    samples_per_pixel: int = 4
    seed: int = 0
    # Rays per chunk of the per-ray engine.
    ray_chunk: int = 8192
    # t_max of bounce rays (>= the scene diagonal is lossless: bounce
    # origins lie on scene geometry). PathTracer fills it from the scene
    # bounds; it shrinks the reach boxes of incoherent ray groups from
    # t_max-sized to scene-sized.
    bounce_t_max: float | None = None
    engine: str = "auto"


def _cap_schedule(mtotal: int, engine: str, n_bounce: int) -> list[int]:
    """Per-bounce lane caps of the compacted secondary pipeline (entry b-1
    is the cap applied after bounce b's sort; 0 = no cut at that bounce).

    Live counts collapse across bounces (config 5 at 512^2 x 2 spp: a
    minority of the 524k lanes live entering bounce 1, a few thousand
    entering bounce 2), so the default is mtotal/4 at bounce 1, then /4
    per further bounce (floored at 4*GROUP). A bounce whose live rays
    overflow its cap runs at full size, so a cap is a speed knob, never a
    correctness one. RTMM_PT_CAP overrides bounce 1 (0 disables every
    cut); RTMM_PT_CAPS='a,b,...' overrides the whole schedule."""
    if engine not in ("pallas", "grouped") or n_bounce < 1:
        return [0] * n_bounce
    env_s = os.environ.get("RTMM_PT_CAPS")
    if env_s:
        caps = [int(x) for x in env_s.split(",")]
        caps += [caps[-1]] * (n_bounce - len(caps))
        caps = caps[:n_bounce]
    else:
        env = os.environ.get("RTMM_PT_CAP")
        c1 = int(env) if env is not None else mtotal // 4
        if c1 <= 0:
            return [0] * n_bounce
        caps = [max(c1 // (4 ** b), 4 * GROUP) for b in range(n_bounce)]
    caps = [(c + GROUP - 1) // GROUP * GROUP if c > 0 else 0 for c in caps]
    return [c if 0 < c < mtotal else 0 for c in caps]


def _resolve_engine(scene: DeviceScene, engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown path-trace engine {engine!r}; one of "
                         f"{ENGINES}")
    if engine == "perray" and scene.compressed:
        raise ValueError(
            "the per-ray reference engine walks the hierarchy tables, "
            "which compressed scenes do not build; use the grouped or "
            "pallas engine (both derive the MT tables from grid records)")
    if engine == "auto":
        return "pallas" if scene.device.type == "cuda" else "grouped"
    return engine


def _trace_chunked(scene: DeviceScene, origins, directions,
                   cfg: RenderConfig, chunk: int):
    """The per-ray backend over chunks of `chunk` rays. Returns (t (n,),
    normal (n, 3), hit (n,)), t = cfg.t_max where a ray misses."""
    outs = [traversal.trace(scene, origins[c0:c0 + chunk],
                            directions[c0:c0 + chunk], cfg)
            for c0 in range(0, origins.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _trace_primary(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                   engine: str):
    """Bounce-0 trace through the primary (tile-frustum) pipeline.

    pallas: the tile-trace kernel's raw mode with a ray-matrix input (one
    launch) when the scene has at most kernel_clusters_per_window
    clusters, else its windowed mode; grouped: the XLA tile backend.
    Returns (t (n,), hit (n,), normal (n, 3) unnormalised) in raster
    order; t is relative to the raygen near-plane origins and t_max where
    the ray misses."""
    width, height = cfg.width, cfg.height
    pw, ph = tiled.padded_size(width, height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    if engine == "pallas":
        fi, frus, raymat = tile_trace.ray_frame_inputs(scene, inv_view_proj,
                                                       cfg)
        meta, tables, opts = tile_trace.scene_tables(scene)
        kc = tile_trace.clusters_per_window(scene, cfg)
        if scene.num_clusters <= kc:
            lists = tile_trace.cluster_lists(scene, fi, kc)
            out, _, _ = tile_trace.trace_raw(*lists, frus, meta, tables, cfg,
                                             raymat=raymat, **opts)
            best_t, best_n = out[:, 0], out[:, 1:4].transpose(1, 2)
        else:
            n_tiles = frus.shape[0]
            dev = frus.device

            def trace_window(ccand, ccount, centry, best_t, rest):
                t, n, vis, elig = tile_trace.trace_windowed(
                    ccand, ccount, centry, frus, raymat, (best_t, *rest),
                    meta, tables, cfg, **opts)
                return t, (n, vis, elig)

            init_t = torch.full((n_tiles, tiled.TILE), BIG,
                                dtype=torch.float32, device=dev)
            init_rest = (torch.zeros((n_tiles, 3, tiled.TILE),
                                     dtype=torch.float32, device=dev),
                         torch.zeros(n_tiles, dtype=torch.int32, device=dev),
                         torch.zeros(n_tiles, dtype=torch.int32, device=dev))
            best_t, (n, _, _), _ = tiled.trace_windowed_clusters(
                scene, fi, trace_window, init_t, init_rest, kc)
            best_n = n.transpose(1, 2)
    else:
        ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32,
                              device=scene.device)
        fi = tiled.build_frame_inputs(scene, ivp, cfg, need_q_frame=True)
        best_t, best_n = tiled.xla_trace_frame(scene, fi, cfg)

    def from_tiles(x):
        k = x.shape[-1]
        return (x.reshape(ty, tx, culling.TILE_H, culling.TILE_W, k)
                .permute(0, 2, 1, 3, 4).reshape(ph, pw, k)
                [:height, :width].reshape(-1, k))

    t = from_tiles(best_t[..., None])[:, 0]
    bn = from_tiles(best_n)
    hit = t < BIG
    return torch.where(hit, t, cfg.t_max), hit, bn


# The plain draw and cosine direction, under the names the port's tests
# hold against jax.random and the JAX package.
_rand2 = path_shade.rand2
_cosine_dir = path_shade.cosine_dir


def _sort_state(scene: DeviceScene, o, d, alive, rad, idx, engine: str):
    """One stable sort of the secondary state: by group key (live rays by
    octant and origin cell, dead rays at the back) for the group engines,
    live rays first for perray."""
    with spans.span("rtmm.pathtrace._sort_state"):
        if engine == "perray":
            skey = torch.where(alive, 0, 1).to(torch.int32)
            skey, order = torch.sort(skey, stable=True)
            return (o[order], d[order], skey == 0, rad[order], idx[order])
        skey = torch.where(alive, grouped._sort_key(o, d, scene),
                           grouped.DEAD_KEY)
        skey, order = torch.sort(skey, stable=True)
        return (o[order], d[order], skey < grouped.DEAD_KEY, rad[order],
                idx[order])


def _trace_perray(scene: DeviceScene, o, d, alive, cfg: RenderConfig,
                  pt: PathTraceConfig):
    """One bounce through the per-ray engine: (t, normal, hit & alive).
    The state is sorted live-first, so only the live prefix is traced (one
    host sync); the dead lanes' hits are masked, so this equals tracing
    every lane."""
    n = o.shape[0]
    n_live = spans.sync("pathtrace.perray_live", alive.sum())
    bt = torch.full((n,), cfg.t_max, dtype=torch.float32, device=o.device)
    bn3 = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    if n_live:
        bt[:n_live], bn3[:n_live], hit[:n_live] = _trace_chunked(
            scene, o[:n_live], d[:n_live], cfg, pt.ray_chunk)
    return bt, bn3, hit & alive


def _stage(timings, name: str, dev: torch.device):
    """The span of one stage, "rtmm.pathtrace." + its kind: with device
    time on a CUDA scene while spans are on, and its CUDA event pair kept
    in timings[name] (a list of (start, end) pairs) when timings is a
    dict."""
    return spans.span("rtmm.pathtrace." + name.split(" ")[0], dev, timings,
                      name)


def path_trace(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
               pt: PathTraceConfig, timings: dict | None = None):
    """Render one frame. Returns (image (H, W, 3) f32, stats) on the
    scene's device: stats["live_rays_per_bounce"] (bounces + 1,) f32 —
    live rays after each bounce, averaged over samples (index 0 the
    primaries) — and the engine's overflow counts (see
    _overflow_stat_key), (bounces + 1,) int32.

    timings (a dict, CUDA scenes only): CUDA-event spans of the stages —
    "primary", "sort b", "trace b" (the engine's secondary trace of bounce
    b, its window loop included), "shade+spawn" (the primaries' and each
    bounce's shading, draws and next rays: path_shade.primary and
    path_shade.bounce, one launch each)."""
    with spans.span("rtmm.path_trace"):
        height, width = cfg.height, cfg.width
        engine = _resolve_engine(scene, pt.engine)
        dev = scene.device
        with _stage(timings, "primary", dev):
            o0, d0 = raygen.generate_rays(inv_view_proj, width, height,
                                          device=dev)
            if engine == "perray":
                t0, bn0, hit0 = _trace_chunked(scene, o0, d0, cfg,
                                               pt.ray_chunk)
            else:
                t0, hit0, bn0 = _trace_primary(scene, inv_view_proj, cfg,
                                               engine)
        n = o0.shape[0]
        n_bounce = pt.bounces
        cfg_bounce = (dataclasses.replace(cfg, t_max=pt.bounce_t_max)
                      if pt.bounce_t_max else cfg)
        sc = path_shade.shading_consts(cfg)
        spp = pt.samples_per_pixel
        ovf_key = _overflow_stat_key(engine)
        # The per-ray state is padded to a GROUP multiple (dead pad lanes) and
        # tiled over the samples: lane g = sample * total + pixel.
        pad = (-n) % GROUP
        total = n + pad
        mtotal = spp * total

        # The primaries' radiance, bounce origins and first spawn (none for
        # primary-only tracing: no secondary state exists).
        with _stage(timings, "shade+spawn", dev):
            radiance0, o, d, alive = path_shade.primary(
                pt.seed, total, spp if n_bounce else 0, bn0, d0, o0, t0, hit0,
                sc)
        live0 = hit0.sum().to(torch.int32)
        if n_bounce == 0:
            return radiance0.reshape(height, width, 3), {
                "live_rays_per_bounce": live0[None].to(torch.float32),
                ovf_key: torch.zeros(1, dtype=torch.int32, device=dev)}

        idx = torch.arange(mtotal, dtype=torch.int32, device=dev)
        rad = torch.zeros((mtotal, 3), dtype=torch.float32, device=dev)

        caps = _cap_schedule(mtotal, engine, n_bounce)
        tails = []          # (rad, idx) of the dead tails cut off, in order
        live_counts, overflows = [], []
        for bounce in range(1, n_bounce + 1):
            with _stage(timings, f"sort {bounce}", dev):
                o, d, alive, rad, idx = _sort_state(scene, o, d, alive, rad,
                                                    idx, engine)
            cap = caps[bounce - 1]
            # The cut is a host decision (the JAX package's lax.cond): one
            # sync per bounce. Past the cap every lane is dead after the sort,
            # so its radiance is final and it is set aside until the unsort.
            if 0 < cap < o.shape[0] and spans.sync("pathtrace.lane_cap",
                                                   alive.sum()) <= cap:
                tails.append((rad[cap:], idx[cap:]))
                o, d, alive, rad, idx = (x[:cap] for x in (o, d, alive, rad,
                                                           idx))
            hit = None
            with _stage(timings, f"trace {bounce}", dev):
                if engine == "perray":
                    bt, bn3, hit = _trace_perray(scene, o, d, alive,
                                                 cfg_bounce, pt)
                    ovf = 0
                else:
                    trace = (group_trace.trace_sorted if engine == "pallas"
                             else grouped.trace_sorted)
                    # bn3 (g, GROUP, 3) is read in place (K2's is a transposed
                    # view); the kernel computes alive & (t < BIG) & (t > 0).
                    bt, bn3, ovf = trace(scene, o.reshape(-1, GROUP, 3),
                                         d.reshape(-1, GROUP, 3),
                                         alive.reshape(-1, GROUP), cfg_bounce)
                    bt = bt.reshape(-1)
            # The grouped engine's count is a tensor; the others' an int.
            overflows.append(spans.sync("pathtrace.overflow", ovf)
                             if isinstance(ovf, torch.Tensor) else ovf)
            spawn = bounce < n_bounce
            with _stage(timings, "shade+spawn", dev):
                # Throughput of every lane read at this bounce: albedo ** b,
                # a constant (the reference's single material).
                out = path_shade.bounce(pt.seed, bounce, total, bn3, d, o, bt,
                                        alive, rad, idx, sc, hit=hit,
                                        spawn=spawn)
            rad, alive = out[0], out[1]
            live_counts.append(alive.sum().to(torch.int32))
            if spawn:
                o, d = out[2], out[3]

        # Undo the permutations: idx is a permutation of [0, mtotal).
        rad = torch.cat([rad] + [t[0] for t in reversed(tails)])
        idx = torch.cat([idx] + [t[1] for t in reversed(tails)])
        out = torch.empty_like(rad)
        out[idx.to(torch.int64)] = rad
        per_sample = out.reshape(spp, total, 3)[:, :n]
        radiance = per_sample[0]
        for s in range(1, spp):
            radiance = radiance + per_sample[s]
        image = (radiance0 + _f32.div(radiance, float(spp))).reshape(
            height, width, 3)
        live = torch.stack([live0 * spp] + live_counts).to(torch.float32)
        stats = {
            "live_rays_per_bounce": _f32.div(live, float(spp)),
            # Index 0 is bounce 0, the exact primary trace: always 0.
            ovf_key: torch.tensor([0] + overflows, dtype=torch.int32,
                                  device=dev),
        }
        return image, stats


def _overflow_stat_key(engine: str) -> str:
    """Stats key of each engine's third trace_sorted return value — the
    engines report different things:

    * "grouped": ``overflow_groups_per_bounce`` — groups whose candidate
      count exceeded the capped candidate list; their farthest candidates
      were dropped, so a nonzero value means possible misses.
    * "pallas": ``extra_window_passes_per_bounce`` — cluster windows
      beyond the first that groups consumed. Nothing is truncated; the
      value is a work signal only.
    * "perray": exact, uncapped — reports ``overflow_groups_per_bounce``,
      always 0.
    """
    return ("extra_window_passes_per_bounce" if engine == "pallas"
            else "overflow_groups_per_bounce")


class PathTracer:
    """Path tracer for one scene: render(inv_view_proj) -> (image, stats).
    Fills bounce_t_max from the scene's cluster bounds (the diagonal x
    1.05 + 1e-3, capped at cfg.t_max)."""

    def __init__(self, scene: DeviceScene, cfg: RenderConfig | None = None,
                 pt: PathTraceConfig | None = None):
        self.scene = scene
        self.cfg = cfg or RenderConfig()
        self.pt = pt or PathTraceConfig()
        _resolve_engine(scene, self.pt.engine)
        if self.pt.bounce_t_max is None:
            lo = scene.cluster_aabb_min.cpu().numpy()
            hi = scene.cluster_aabb_max.cpu().numpy()
            valid = scene.cluster_valid.cpu().numpy()
            diag = float(np.linalg.norm(hi[valid].max(0) - lo[valid].min(0)))
            self.pt = dataclasses.replace(
                self.pt, bounce_t_max=min(self.cfg.t_max,
                                          diag * 1.05 + 1e-3))

    def render(self, inv_view_proj, timings: dict | None = None):
        return path_trace(self.scene, inv_view_proj, self.cfg, self.pt,
                          timings)
