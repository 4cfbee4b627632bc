"""The frame prologue's host time and device time, split, on one NVIDIA
card: what each prologue call costs on the host (the Python and the
launches it enqueues) against what its kernels take on the device.

    python3 tools/prologue_split.py [--tree DIR] [--out FILE] [CONFIG ...]

--tree imports rtmm_tpu_torch from DIR instead of this checkout (a `git
archive` of another commit unpacked there), so that two versions are
measured with one script on one card. CONFIG is a bench config number of
1, 3, 5, 6 and 8 (all five by default), built as the port's benchmark
builds it (rtmm_tpu_torch/bench.py::_build_config_raw), at its bench size:
  1, 3, 6   one launch chunk of the fused orbit (the bench's 256 or 32
            frames per call, tile_trace.frames_per_launch of them):
            tile_trace.frames_inputs;
  5         config 5's primary prologue at 512x512 with 8 sub-cones:
            tile_trace.ray_frame_inputs, then cluster_lists;
  8         one frame of the merged two-level prologue of 64 instances:
            instances.world_frame, then merged_launch_inputs.
For each call: host ms (from a synchronised start until the call
returns, median of 5), wall ms (until the card is done, median of 5),
device busy ms and kernel events (torch.profiler over one call:
utils/stats.py's device_busy) and peak MiB allocated. Then the same for
each piece the call is built from, alone on its inputs: the plain
functions (culling.tile_frustums, tile_sub_frustums, cull_units,
tiled.frustum_scalars, and cluster_window's plain body: aabb_distance,
then tiled._select_nearest_clusters; instances.instance_cull)
and, where the tree has them, the prologue kernels (ops/prologue.py:
tile_frusta, cluster_select). Prints one JSON line per config and the
card as nvidia-smi reports it; --out also writes the lines to FILE.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _host_wall_ms(fn, rounds: int = 5) -> tuple[float, float]:
    host, wall = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def _measure(fn) -> dict:
    """Host, wall and device time, kernel events and peak MiB of fn."""
    from rtmm_tpu_torch.utils import stats
    fn()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    host, wall = _host_wall_ms(fn)
    with tempfile.TemporaryDirectory() as logdir:
        with stats.profiler_trace(logdir):
            fn()
        busy = stats.device_busy(logdir)
    return {"host_ms": host, "wall_ms": wall,
            "device_busy_ms": busy["busy_us"] / 1e3,
            "kernel_events": busy["kernels"], "peak_mib": peak}


def _fused_pieces(scene, chunk, cfg, kc) -> dict:
    """The fused chunk's prologue piece by piece, each on its inputs."""
    from rtmm_tpu_torch.ops import culling, tiled
    w, h = cfg.width, cfg.height
    pw, ph = tiled.padded_size(w, h)
    dev = scene.device
    apex, normals = culling.tile_frustums(chunk, w, h, pw, ph, device=dev)
    sub = culling.tile_sub_frustums(chunk, w, h, pw, ph, n_sub=cfg.sub_frusta,
                                    n_rows=cfg.sub_rows, device=dev)
    hit = culling.cull_units(apex, normals, scene.cluster_aabb_min,
                             scene.cluster_aabb_max, scene.cluster_valid)
    fi = tiled.FrameInputs(None, None, apex, normals, hit, sub,
                           scene.exit_aabb)
    pieces = {
        "tile_frustums": lambda: culling.tile_frustums(
            chunk, w, h, pw, ph, device=dev),
        "tile_sub_frustums": lambda: culling.tile_sub_frustums(
            chunk, w, h, pw, ph, n_sub=cfg.sub_frusta, n_rows=cfg.sub_rows,
            device=dev),
        "cull_units": lambda: culling.cull_units(
            apex, normals, scene.cluster_aabb_min, scene.cluster_aabb_max,
            scene.cluster_valid),
        "frustum_scalars": lambda: tiled.frustum_scalars(
            fi, raygen_ivp=chunk, tx=pw // culling.TILE_W),
        # cluster_window's plain body (the distances, then the select), so
        # that the piece is the plain function on every tree.
        "cluster_window": lambda: tiled._select_nearest_clusters(
            culling.aabb_distance(apex[..., None, :], scene.cluster_aabb_min,
                                  scene.cluster_aabb_max)[..., None, :],
            hit, kc),
    }
    try:
        from rtmm_tpu_torch.ops import prologue
    except ImportError:
        return pieces
    rows = normals.reshape(-1, 4, 3)
    n_tiles = normals.shape[1]
    pieces["tile_frusta"] = lambda: prologue.tile_frusta(
        chunk, w, h, pw, ph, cfg.sub_frusta, cfg.sub_rows, pack="raygen",
        scene_aabb=scene.exit_aabb)
    pieces["cluster_select"] = lambda: prologue.cluster_select(
        apex, rows, scene.cluster_aabb_min, scene.cluster_aabb_max,
        scene.cluster_valid, kc, rows_per_apex=n_tiles)
    return pieces


def _config(n: int) -> dict:
    from rtmm_tpu_torch import bench
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod
    c = bench._build_config_raw(n, device="cuda")
    cfg = c.cfg
    if n in (1, 3, 6):
        scene = c.scene
        frames = bench._frames_per_call(cfg)
        f = tile_trace.frames_per_launch(cfg, frames)
        chunk = bench._orbit_cameras(cfg, frames, bench.YAW, c.dist,
                                     "cuda")[:f]
        kc = tile_trace.clusters_per_window(scene, cfg)
        call = {"frames_inputs": lambda: tile_trace.frames_inputs(
            scene, chunk, cfg, kc)}
        pieces = _fused_pieces(scene, chunk, cfg, kc)
        per = f
    elif n == 5:
        scene = c.scene
        ivp = torch.as_tensor(bench._camera(cfg.width, cfg.height, c.dist),
                              dtype=torch.float32, device="cuda")
        kc = tile_trace.clusters_per_window(scene, cfg)

        def primary():
            fi, _, _ = tile_trace.ray_frame_inputs(scene, ivp, cfg)
            return tile_trace.cluster_lists(scene, fi, kc)

        fi, _, _ = tile_trace.ray_frame_inputs(scene, ivp, cfg)
        call = {"ray_frame_inputs + cluster_lists": primary}
        pieces = {"ray_frame_inputs": lambda: tile_trace.ray_frame_inputs(
                      scene, ivp, cfg),
                  "cluster_lists": lambda: tile_trace.cluster_lists(
                      scene, fi, kc)}
        per = 1
    elif n == 8:
        base, ring = c.scene
        ivp = torch.as_tensor(bench._camera(cfg.width, cfg.height, c.dist),
                              dtype=torch.float32, device="cuda")
        rot, trn, scl = inst_mod.instance_tensors(ring, "cuda")

        def merged():
            world = inst_mod.world_frame(ivp, cfg, "cuda")
            return inst_mod.merged_launch_inputs(base, rot, trn, scl, ivp,
                                                 world, cfg)

        world = inst_mod.world_frame(ivp, cfg, "cuda")
        call = {"world_frame + merged_launch_inputs": merged}
        pieces = {"world_frame": lambda: inst_mod.world_frame(ivp, cfg,
                                                              "cuda"),
                  "instance_cull": lambda: inst_mod.instance_cull(
                      base, rot, trn, scl, world),
                  "merged_launch_inputs": lambda: inst_mod.merged_launch_inputs(
                      base, rot, trn, scl, ivp, world, cfg)}
        per = 1
    else:
        raise ValueError(f"config {n} has no prologue measurement here")
    name, fn = next(iter(call.items()))
    out = {"config": n, "call": name, "frames": per,
           "size": f"{cfg.width}x{cfg.height}", **_measure(fn)}
    out["per_frame"] = {k: out[k] / per for k in
                        ("host_ms", "wall_ms", "device_busy_ms")}
    out["pieces"] = {k: _measure(p) for k, p in pieces.items()}
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(ROOT))
    parser.add_argument("--out")
    parser.add_argument("configs", nargs="*", type=int,
                        default=[3, 6, 1, 8, 5])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("prologue_split: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import rtmm_tpu_torch
    print(f"[tree] {Path(rtmm_tpu_torch.__file__).parent}", flush=True)
    lines = []
    for n in args.configs:
        line = json.dumps(_config(n))
        print(line, flush=True)
        lines.append(line)
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
