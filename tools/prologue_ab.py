"""The prologue kernels' cases of chip_smoke.py, on one NVIDIA card, for
one or more trees in turns: each case's kernel bit for bit against its
plain version, device ms per launch (20 queued behind a spin), wrapper
ms, plain ms and the bound, as chip_smoke.py's `_prologue_case` takes
them.

    python3 tools/prologue_ab.py [--out FILE] [TREE ...]

TREE is a directory inside this checkout holding rtmm_tpu_torch (a `git
archive` of another commit unpacked under build/, e.g. build/parent;
this checkout by default); a tree outside the checkout is refused, since
each tree builds its kernels under its own build/. Each tree runs in a
process of its own, with its own kernel build, with this checkout's
chip_smoke.py driving it; give trees as parent, change, change, parent
(`build/parent . . build/parent`) to compare two versions on one card. The cases, on chip_smoke.py's
scenes and cameras: configs 3 and 6's 32-frame 1080p chunks (phase 6c),
config 7 at full size (707x707, compressed, 15,621 clusters: its frusta,
its cull and two windows of 256; phase 7c), config 8's world frusta,
instance cull and merged rows (64 instances; phase 9), config 5's
primary frusta, cull and lists (512x512, 8 sub-cones; phase 14). Prints
one JSON line per tree ({"tree", "cases": {kernel: {case: numbers}}})
and the card as nvidia-smi reports it; --out also writes the lines to
FILE. Exits non-zero without a card or if any case differs from its
plain version.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "[prologue_ab] "


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
    from rtmm_tpu_torch.ops import _build
    cs = _chip_smoke()
    cs._log(f"[tree] {Path(rtmm_tpu_torch.__file__).parent}")
    _build.build_all()
    card = cs._card_line()
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT)
    ivp = cs._camera(25.0, cfg)
    t0 = time.perf_counter()
    scenes = {
        "config 3": scene_mod.build_device_scene(
            procedural.make_icosphere(subdivisions=3, level=3,
                                      amplitude=0.12), device="cuda"),
        "config 6": scene_mod.build_device_scene(
            procedural.make_plane(grid=(160, 160), level=2, amplitude=0.05),
            device="cuda")}
    cs.phase_prologue_kernels(card, scenes, cfg)
    del scenes
    mesh = procedural.make_plane(grid=(cs.GRID_7_FULL, cs.GRID_7_FULL),
                                 level=3, amplitude=0.05)
    scene7 = scene_mod.build_device_scene(mesh, compressed=True,
                                          device="cuda")
    del mesh
    cs._prologue_frame_cases(card, "config 7", scene7, ivp, cfg, windows=2)
    del scene7
    torch.cuda.empty_cache()
    base = scene_mod.build_device_scene(procedural.make_icosphere(
        subdivisions=1, level=3, amplitude=0.12), device="cuda")
    cs._prologue_instanced_cases(card, "config 8", base, cs._ring(64),
                                 cs._camera(25.0, cfg, cs.DIST_8), cfg)
    cfg5 = RenderConfig(width=cs.PT_SIZE, height=cs.PT_SIZE, sub_frusta=8)
    scene5 = scene_mod.build_device_scene(procedural.make_icosphere(
        subdivisions=0, level=5, amplitude=0.1), device="cuda")
    cs._prologue_frame_cases(card, "config 5 primary", scene5,
                             cs._camera(25.0, cfg5), cfg5)
    print(MARK + json.dumps({"tree": tree, "card": card,
                             "seconds": time.perf_counter() - t0,
                             "cases": cs.PROLOGUE_CASES}), flush=True)
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
        print("prologue_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.child:
        return _child(args.child)
    lines = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", tree],
            capture_output=True, text=True, timeout=1800)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"prologue_ab: {tree} failed (exit {proc.returncode})",
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
