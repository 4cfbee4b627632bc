"""CLI application (PyTorch/CUDA port).

Mirrors the reference entry point (src/application.cpp:333-364):
`rtmm <mesh.gltf> [-T]` — positional micro-mesh asset plus the optional
tessellated ground-truth mode. A headless host has no Win32 swapchain, so
the "window" is an offline frame sequence: the trackball camera orbits and
frames are written as PNG.

    python -m rtmm_tpu_torch.app proc:sphere?level=3 --width 256 \
        --height 256 --frames 2 --out frames            # on the card
    python -m rtmm_tpu_torch.app ... --device cpu       # plain PyTorch
    python -m rtmm_tpu_torch.app proc:sphere?level=3 --pathtrace 3 \
        --spp 2 --width 256 --height 256                 # path tracer
    python -m rtmm_tpu_torch.app proc:sphere?level=3 --pipeline ray  # per-ray
    python -m rtmm_tpu_torch.app proc:sphere?level=3 --stats  # + heatmap PNG
    python -m rtmm_tpu_torch.app a.gltf --cache         # scene cache
    python -m rtmm_tpu_torch.app a.gltf --dump-bary     # .bary inspector
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from .config import RenderConfig
from .io import bary as bary_mod
from .io import gltf as gltf_mod
from .io import image as image_io
from .models import procedural, scene as scene_mod
from .ops import tile_trace
from .render import instances as inst_mod
from .render import pathtrace
from .render.renderer import FramePipeline, Renderer, _quantize
from .utils import camera, spans
from .utils import stats as stats_mod


def load_asset(path: str):
    """Load a micro-mesh: .gltf/.glb via the asset loader, or a procedural
    spec `proc:<name>?key=val,...` (e.g. proc:plane?level=3)."""
    if path.startswith("proc:"):
        spec = path[5:]
        name, _, args = spec.partition("?")
        kwargs = {}
        for kv in filter(None, args.split(",")):
            k, _, v = kv.partition("=")
            kwargs[k] = float(v) if "." in v else int(v)
        if name == "plane":
            lvl = int(kwargs.pop("level", 3))
            g = int(kwargs.pop("grid", 4))
            return procedural.make_plane(grid=(g, g), level=lvl, **kwargs)
        if name == "sphere":
            lvl = int(kwargs.pop("level", 3))
            sub = int(kwargs.pop("subdivisions", 1))
            return procedural.make_icosphere(subdivisions=sub, level=lvl,
                                             **kwargs)
        raise SystemExit(f"unknown procedural asset '{name}'")
    from .io import loader
    return loader.load_micromesh(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rtmm-torch",
        description="micro-mesh ray tracer (PyTorch/CUDA port)")
    parser.add_argument("asset", help=".gltf micro-mesh or proc:<spec>")
    parser.add_argument("-T", dest="tessellated", action="store_true",
                        help="pre-tessellate and trace plain triangles "
                             "(ground-truth mode, README.md:7-12)")
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--orbit", type=float, default=2.0,
                        help="degrees of yaw per frame")
    parser.add_argument("--distance", type=float, default=4.0)
    parser.add_argument("--pitch", type=float, default=-30.0)
    parser.add_argument("--yaw", type=float, default=20.0)
    parser.add_argument("--out", default="frames")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the trace kernel on the card; cpu: its "
                             "plain PyTorch version")
    parser.add_argument("--pipeline", default="auto",
                        choices=["auto", "pallas", "ray", "tile"],
                        help="trace backend: auto and pallas are the tile "
                             "kernel (its plain version on the CPU); tile "
                             "is the kernel-free XLA tile backend; ray is "
                             "the per-ray reference backend")
    parser.add_argument("--compressed", action="store_true",
                        help="store only per-unit grid-vertex records and "
                             "derive each visited unit's tables in the "
                             "trace kernel (the reference's direct-tracing "
                             "memory model)")
    parser.add_argument("--compare-t", action="store_true",
                        help="render both micro-mesh and tessellated modes "
                             "and report the image RMSE (the reference's "
                             "implicit correctness oracle)")
    parser.add_argument("--instances", type=int, default=1,
                        help="replicate the asset in a ring of N instances "
                             "(TLAS analog demo)")
    parser.add_argument("--tlas", action="store_true",
                        help="with --instances: true two-level traversal "
                             "(per-instance ray transform into the shared "
                             "BLAS, O(scene+N) memory) instead of baking "
                             "world-space copies")
    parser.add_argument("--pathtrace", type=int, default=0,
                        metavar="BOUNCES",
                        help="path-trace N bounces (Lambertian, the "
                             "reference's lights + sky term)")
    parser.add_argument("--spp", type=int, default=4,
                        help="samples per pixel for --pathtrace")
    parser.add_argument("--stats", action="store_true",
                        help="print per-frame traversal statistics, the "
                             "frame's spans (host self ms per span, device "
                             "ms of the stages, syncs, launches) and write "
                             "a step heatmap PNG (with --pathtrace: the "
                             "live rays per bounce and the spans)")
    parser.add_argument("--cache", action="store_true",
                        help="cache scene precompute keyed by asset hash")
    parser.add_argument("--dump-bary", action="store_true",
                        help="inspect the asset's .bary container (header, "
                             "property table, group/triangle/value info) "
                             "and exit")
    args = parser.parse_args(argv)

    if not args.asset.startswith("proc:") and not os.path.exists(args.asset):
        print("Micro-mesh file does not exist.", file=sys.stderr)
        return 1
    if args.dump_bary:
        return _dump_bary(args.asset)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available "
              "(use --device cpu for the plain PyTorch path)",
              file=sys.stderr)
        return 1

    cfg = RenderConfig(width=args.width, height=args.height,
                       pipeline=args.pipeline)
    # The per-node hierarchy tables feed only the per-ray reference backend
    # (pipeline ray) and the --stats step-count heatmap; production renders
    # skip building and uploading them.
    hierarchy = args.pipeline == "ray" or args.stats
    t0 = time.perf_counter()
    mesh = None
    if args.cache and not args.asset.startswith("proc:"):
        from .utils.cache import build_device_scene_cached
        ds = build_device_scene_cached(args.asset,
                                       tessellated=args.tessellated,
                                       hierarchy=hierarchy,
                                       compressed=args.compressed,
                                       device=args.device)
    else:
        mesh = load_asset(args.asset)
        print(f"loaded: {mesh.num_triangles} base triangles, "
              f"max subdivision level {mesh.max_level}, "
              f"uniform={mesh.has_uniform_subdivision_level()}")
        ds = scene_mod.build_device_scene(mesh, tessellated=args.tessellated,
                                          hierarchy=hierarchy,
                                          compressed=args.compressed,
                                          device=args.device)
    mode = ("tessellated" if args.tessellated
            else "compressed" if args.compressed else "micromesh")
    print(f"scene build: {time.perf_counter() - t0:.2f}s "
          f"(mode={mode}, device={args.device})")

    instance_ring = None
    if args.instances > 1:
        n = args.instances
        ring = []
        for i in range(n):
            a = 2.0 * np.pi * i / n
            ring.append(inst_mod.Instance.from_euler(
                [2.2 * np.cos(a), 2.2 * np.sin(a), 0.0],
                (0.0, a, 0.0), 0.8))
        if args.tlas:
            instance_ring = ring
            print(f"instanced (two-level TLAS): {n} instances, shared BLAS")
        else:
            ds = inst_mod.bake_instances(ds, ring)
            print(f"instanced: {n} instances, "
                  f"{ds.num_triangles} triangles total")

    tb = camera.Trackball(distance=args.distance)
    tb.set_camera([0.0, 0.0, 0.0],
                  [np.radians(args.pitch), np.radians(args.yaw), 0.0],
                  args.distance)

    if args.compare_t:
        if mesh is None:
            mesh = load_asset(args.asset)
        ds_t = scene_mod.build_device_scene(mesh, tessellated=True,
                                            hierarchy=hierarchy,
                                            device=args.device)
        ivp = camera.inv_view_proj(tb, cfg.width, cfg.height,
                                   cfg.fov_y_degrees, cfg.near, cfg.far)
        img_mm = Renderer(ds, cfg).render(ivp).cpu().numpy()
        img_ts = Renderer(ds_t, cfg).render(ivp).cpu().numpy()
        rmse = float(np.sqrt(((img_mm - img_ts) ** 2).mean()))
        npix = int((np.abs(img_mm - img_ts).max(-1) > 1e-3).sum())
        print(f"micromesh vs tessellated: RMSE={rmse:.3e}, "
              f"pixels>1e-3: {npix} of {cfg.width * cfg.height} "
              f"({'PASS' if rmse <= 1e-3 else 'FAIL'} at 1e-3)")
        return 0 if rmse <= 1e-3 else 2

    if args.pathtrace > 0:
        return _path_trace(ds, cfg, tb, args)
    if instance_ring is not None:
        renderer = inst_mod.InstancedRenderer(ds, instance_ring, cfg)
    else:
        renderer = Renderer(ds, cfg)
    pipe = FramePipeline(renderer)
    os.makedirs(args.out, exist_ok=True)
    written = 0

    def write(img):
        nonlocal written
        path = os.path.join(args.out, f"frame_{written:04d}.png")
        image_io.write_png(path, img)
        print(f"frame {written} -> {path}")
        written += 1

    t0 = time.perf_counter()
    for frame in range(args.frames):
        ivp = camera.inv_view_proj(tb, cfg.width, cfg.height,
                                   cfg.fov_y_degrees, cfg.near, cfg.far)
        before = spans.counters()
        with spans.on() if args.stats else contextlib.nullcontext():
            done = pipe.submit(ivp)
        if done is not None:
            write(done)
        if args.stats:
            _print_spans(before)
            _frame_stats(ds, ivp, cfg, args, frame)
        tb.rotation_euler[1] -= np.radians(args.orbit)
    for done in pipe.drain():
        write(done)
    dt = time.perf_counter() - t0
    print(f"{args.frames} frame(s) in {dt * 1e3:.1f} ms on {args.device} "
          f"({args.frames * cfg.width * cfg.height / dt / 1e6:.2f} Mrays/s, "
          "PNG writes included)")
    return 0


def _dump_bary(path: str) -> int:
    """--dump-bary: print the .bary container of the asset (or of the
    .gltf's NV displacement-micromap reference)."""
    if path.endswith((".gltf", ".glb")):
        resolved = gltf_mod.Gltf.load(path).micromap_uri()
        if not resolved:
            print("gltf has no NV displacement-micromap .bary reference",
                  file=sys.stderr)
            return 1
        path = resolved
    print(bary_mod.dump_bary(path))
    return 0


def _print_spans(before: dict) -> None:
    """--stats: the frame's spans (utils/spans.py): host self ms per span
    name, device ms of the stage spans, and the syncs and uploads per
    site and kernel launches since the counters() snapshot `before`."""
    s = spans.summary(spans.take(), before)
    for kind in ("host_self_ms", "device_ms"):
        s[kind] = {k: round(v, 4) for k, v in sorted(s[kind].items())}
    print("  spans:", s)


def _frame_stats(ds, ivp, cfg: RenderConfig, args, frame: int) -> None:
    """--stats: the traversal-step heatmap (written as a PNG beside the
    frames) and FrameStats; when the tile kernel renders the frame, its
    exact per-tile unit visit and eligible counters too."""
    hm = stats_mod.traversal_heatmap(ds, ivp, cfg)
    print("  stats:",
          stats_mod.collect_frame_stats(ds, ivp, cfg, heatmap=hm).as_dict())
    hm_path = os.path.join(args.out, f"heatmap_{frame:04d}.png")
    stats_mod.heatmap_to_png(hm_path, hm)
    print(f"  heatmap: max {int(hm.max())} steps/ray -> {hm_path}")
    if args.instances <= 1 and cfg.pipeline in ("auto", "pallas"):
        _img, kst = tile_trace.render_frame(ds, ivp, cfg, with_stats=True)
        kv = kst["kernel_unit_visits"].cpu().numpy()
        ke = kst["kernel_unit_eligible"].cpu().numpy()
        print(f"  kernel visits: {int(kv.sum())} (tile,unit) steps"
              f" of {int(ke.sum())} eligible"
              f" (slab pre-test skipped"
              f" {int(ke.sum()) - int(kv.sum())}),"
              f" max/tile {int(kv.max())},"
              f" nonempty tiles {int((kv > 0).sum())}")


def _path_trace(ds, cfg: RenderConfig, tb, args) -> int:
    """--pathtrace N --spp K: frames through PathTracer with 8 sub-cones
    per tile (silhouette tiles dominate the primary trace of a path-traced
    frame), written as PNG."""
    tracer = pathtrace.PathTracer(
        ds, dataclasses.replace(cfg, sub_frusta=8),
        pathtrace.PathTraceConfig(bounces=args.pathtrace,
                                  samples_per_pixel=args.spp))
    os.makedirs(args.out, exist_ok=True)
    for frame in range(args.frames):
        ivp = camera.inv_view_proj(tb, cfg.width, cfg.height,
                                   cfg.fov_y_degrees, cfg.near, cfg.far)
        before = spans.counters()
        t0 = time.perf_counter()
        with spans.on() if args.stats else contextlib.nullcontext():
            img, stats = tracer.render(ivp)
        u8 = _quantize(img).cpu().numpy()
        dt = time.perf_counter() - t0
        path = os.path.join(args.out, f"frame_{frame:04d}.png")
        image_io.write_png(path, u8)
        print(f"frame {frame}: {dt * 1e3:.1f} ms on {args.device} "
              f"({tracer.pt.bounces} bounces, {tracer.pt.samples_per_pixel} "
              f"spp) -> {path}")
        if args.stats:
            print("  live rays/bounce:",
                  stats["live_rays_per_bounce"].tolist())
            _print_spans(before)
        tb.rotation_euler[1] -= np.radians(args.orbit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
