"""Config 5's per-bounce work outside the trace on one NVIDIA card, for
one or more trees in turns: the bounce kernels' device time, their
wrappers' host time and the frame's kernel launch calls, per frame.

    python3 tools/pt_frame_ab.py [--out FILE] [TREE ...]

TREE is a directory inside this checkout holding rtmm_tpu_torch (a `git
archive` of another commit unpacked under build/, e.g. build/parent;
this checkout by default); a tree outside the checkout is refused, since
each tree builds its kernels under its own build/. Each tree runs in a
process of its own, with its own kernel build, with this checkout's
chip_smoke.py driving it; give trees as parent, change, change, parent
(`build/parent . . build/parent`) to compare two versions on one card.

Per tree, on chip_smoke.py's config 5 (a level-5 icosphere at 512x512, 8
sub-cones, 3 bounces, 2 samples per pixel, the verify camera): frame 0
is rendered with the bounce kernels' wrappers recorded (whichever of
ops/path_shade.py's spawn / shade or primary / bounce the tree has);
each recorded call is then replayed for its device ms per launch (20
queued behind a spin, chip_smoke._queued_ms) and its wrapper ms per call
(20 calls back to back, CUDA events: host-bound, so host work), summed
over the frame; the frame's kernel launch calls (torch.profiler's host
events, chip_smoke._profiled); the stages of the bounce work (CUDA
events: "spawn" + "shading", or "shade+spawn"), median of 5 frames; the
frame's ms (CUDA events, median of 5); and the image's sum and live
counts, which must agree between trees. Prints one JSON line per tree
and the card as nvidia-smi reports it; --out also writes the lines to
FILE. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "[pt_frame_ab] "
WRAPPERS = ("spawn", "shade", "primary", "bounce")
FRAMES = 5


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever tree rtmm_tpu_torch is
    imported from."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child(tree: str) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import rtmm_tpu_torch
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import _build, path_shade
    from rtmm_tpu_torch.render import pathtrace
    cs = _chip_smoke()
    cs._log(f"[tree] {Path(rtmm_tpu_torch.__file__).parent}")
    _build.build_all()
    card = cs._card_line()
    t0 = time.perf_counter()
    scene = scene_mod.build_device_scene(procedural.make_icosphere(
        subdivisions=0, level=5, amplitude=0.1), device="cuda")
    cfg = RenderConfig(width=cs.PT_SIZE, height=cs.PT_SIZE, sub_frusta=8)
    tracer = pathtrace.PathTracer(scene, cfg, pathtrace.PathTraceConfig(
        bounces=cs.PT_BOUNCES, samples_per_pixel=cs.PT_SPP,
        ray_chunk=16384))
    ivp = cs._camera(25.0, cfg)
    tracer.render(ivp)
    torch.cuda.synchronize()

    names = [k for k in WRAPPERS if hasattr(path_shade, k)]
    orig = {k: getattr(path_shade, k) for k in names}
    calls = []

    def recorder(name):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return orig[name](*args, **kwargs)
        return call

    for k in names:
        setattr(path_shade, k, recorder(k))
    try:
        img, st = tracer.render(ivp)
    finally:
        for k in names:
            setattr(path_shade, k, orig[k])
    torch.cuda.synchronize()

    per_call = []
    for name, args, kwargs in calls:
        def once(name=name, args=args, kwargs=kwargs):
            orig[name](*args, **kwargs)
        once()
        torch.cuda.synchronize()
        per_call.append({"wrapper": name,
                         "device_ms": cs._queued_ms(once),
                         "wrapper_ms": cs._events_ms(once, reps=20)})
    launch_calls = [cs._profiled(lambda: tracer.render(ivp))["launch_calls"]
                    for _ in range(2)]
    stages = [cs._frame_stages(tracer, ivp) for _ in range(FRAMES)]
    work = statistics.median(
        s.get("shade+spawn", s.get("spawn", 0.0) + s.get("shading", 0.0))
        for s in stages)
    frame_ms = cs._events_ms(lambda: tracer.render(ivp), reps=1,
                             rounds=FRAMES)
    print(MARK + json.dumps({
        "tree": tree, "card": card, "seconds": time.perf_counter() - t0,
        "wrappers": names, "calls": per_call,
        "device_ms_per_frame": sum(c["device_ms"] for c in per_call),
        "wrapper_ms_per_frame": sum(c["wrapper_ms"] for c in per_call),
        "launch_calls_per_frame": launch_calls,
        "bounce_work_stage_ms": work, "frame_ms": frame_ms,
        "image_sum": float(img.double().sum()),
        "live_rays_per_bounce": st["live_rays_per_bounce"].tolist()}),
        flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("trees", nargs="*", default=[str(ROOT)])
    args = parser.parse_args()
    outside = [t for t in args.trees
               if not Path(t).resolve().is_relative_to(ROOT)]
    if outside:
        parser.error(f"trees outside the checkout {ROOT}: {outside}")
    import torch
    if not torch.cuda.is_available():
        print("pt_frame_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.child:
        return _child(args.child)
    lines = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", tree],
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"pt_frame_ab: {tree} failed (exit {proc.returncode})",
                  file=sys.stderr)
            return 1
        lines += [ln[len(MARK):] for ln in proc.stdout.splitlines()
                  if ln.startswith(MARK)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
