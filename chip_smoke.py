"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card and build: the card's name and power limit; nvcc builds every
     kernel of rtmm_tpu_torch/csrc (one process per source, started
     together) and ptxas's register/shared-memory/spill report is printed,
     then each tile-trace instantiation's registers, spill bytes, static
     shared memory and resident blocks per SM as the runtime reports them;
     each K1 phase prints its launch's ms beside the ms before K1's
     redesign and both against the bound;
  2. scene: bench config 3 (a 1,280-base-triangle subdiv-3 icosphere,
     81,920 micro-triangles) written as .gltf + .bary and read back through
     the port's io path, uploaded to the card;
  3. main path, with the launch counters set to 0 just before and read
     just after: one 1920x1080 frame with stats, a 32-frame orbit through
     render_frames (one launch), Renderer.render_u8 for 2 frames and a
     FramePipeline over 3 frames;
  4. correctness: the kernel against its plain PyTorch version on the same
     inputs on the card (two-tier image gate, per-tile visit and eligible
     counts equal), total visits within 5% of the fixed-camera pin;
  5. timing with CUDA events: the kernel on one frame's inputs, the
     32-frame orbit, the plain version, and the kernel's bound;
  6. bench config 9 (51,200-triangle level-2 plane, compressed: the
     kernel derives each visited unit's tables, K1c) at 1080p: main path
     counted (one frame + an 8-frame orbit), visits within 5% of the pin,
     kernel vs plain on the full frame, the frame against config 6 (the
     same mesh with precomputed tables, K1a), timing and bound;
  7. windowed walks (K1b): (a) config 3 with 4 clusters per window,
     against phase 3's fused frame, and (b) config 7's construction
     (level-3 plane, compressed) cut from a 707x707 to a 160x160 grid
     (800 clusters) and from 256 to 16 clusters per window, both counted,
     kernel vs plain on the first window's launch, timing and bound;
  8. bench config 4 (6 baked instances of an 80-triangle level-3
     icosphere, K1a): baked on the card, visits within 5% of the pin, the
     frame within the gate of the same ring through render_instanced;
  9. bench config 8 (64 instances, two-level, K1d), this slice's main
     path, counted: frames through InstancedRenderer and an 8-frame orbit,
     one raw launch per merged frame; the launch's inputs built once, the
     raw kernel against its plain version; the merged frame against the
     serial scan at 480x288; times of the launch, the frame and its stages;
 10. config 8 over a compressed base (K1d + K1c), kernel vs plain on a row
     subset, the frame against the precomputed one;
 11. forced overflow: config 8's ring at 480x288 with a pool of one row
     per instance; the truncated instances re-run through K1b;
 12. bench config 10 (256 instances): frame time and covered fraction
     beside config 8's, kernel vs plain on a row subset;
 13. the raw mode with a ray-matrix input on config 3: bit for bit one
     windowed launch with fresh carries, and against its plain version;
 14. bench config 5, the path tracer (a level-5 icosphere at 512x512,
     8 sub-cones, 3 bounces, 2 samples per pixel), counted: PathTracer.render
     for 2 frames and a 32-frame orbit frame by frame, one raw launch (K1d)
     per frame and one grouped-trace launch (K2) per window of each bounce;
     K2 against its plain version on every launch of frame 0 (t, visits,
     gated sub-groups and tests equal, bounce 1's visits and gated held to
     their pins), each bounce's K2 ms beside the ms before the redesign;
     the reference's engine gate (bench.py:543-585: the pallas and grouped
     engines on one 256x256 frame, and the grouped engine once more with
     no candidate cut, to see whether the cut explains a live-count
     difference); the lane cuts against none, bit for bit; frame, orbit,
     stage times, K2's bound over its tests, and the grouped engine's
     trace of the same bounce;
 15. config 5 compressed (K1d + K1c, K2 compressed): counted frames, K2
     against its plain version on every launch of frame 0 as in phase 14,
     the frame within the gate of phase 14's, the frame's stage times,
     MiB of both scenes.

The last lines are the kernel table as JSON, the card as nvidia-smi
reports it, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Config 3's deterministic per-frame (tile, unit) visit count at the fixed
# verify camera (pitch -30 deg, yaw 25 deg, distance 3.0): bench.py:264,
# EXPECTED_VISITS[3] = 5359, with bench.py's 5% tolerance.
EXPECTED_VISITS = 5359
VISITS_RTOL = 0.05
WIDTH, HEIGHT = 1920, 1080
# The kernel and its plain version do the same float32 operations in the
# same order (nvcc -fmad=false); only exact-t ties may sum winner normals
# in another order, a last-bit difference in the shaded colour.
MAX_ABS_ERR = 1e-5
ORBIT_FRAMES = 32
# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per (ray, leaf) test that the function needs, from
# process_unit in csrc/tile_trace.cu over the unit table's non-zero terms:
# the table is [-n | -w1 | -w2 | w] over the d rows and [0 | e2 | -e1 | w]
# over the moment rows, so det is a 3-term dot (3 mul + 2 add) and u, v
# and the w column are 6-term dots (6 mul + 5 add each); then one
# division, four quotient products, four window compares, one select, one
# running-minimum compare. Per (ray, unit) visit add the recentered moment
# (9) and the fold (tb select, subtract, compare, take = 4). The kernel
# also multiplies the det column's three zeros.
OPS_PER_RAY_LEAF = 5 + 3 * 11 + 1 + 4 + 4 + 1 + 1
OPS_PER_RAY_VISIT = 64 * OPS_PER_RAY_LEAF + 9 + 4
TILE_RAYS = 32 * 32
# float32 operations per leaf of a compressed unit visit, counted from
# stage_grid_units: edges 6, recentred v0 3, three cross products 27,
# e2.w2 5, t_num over the unit's recentred apex 6 (3 mul + 2 add + 1 sub),
# the w column's non-zero entries 9 ((-n + w1) + w2 over d, e1 - e2 over
# the moment), the normal's norm 7 and its three divisions 3. Sign flips
# and entries that are 0 are not counted.
DERIVE_OPS_PER_LEAF = 6 + 3 + 27 + 5 + 6 + 9 + 7 + 3
# Bench config 9 (bench.py:113-122) and its visit pin (bench.py:268), and
# the cuts of config 7 (bench.py:106-112: a 707x707 grid, 10^6 triangles,
# 15,625 clusters) that the windowed compressed phase renders: a 160x160
# grid (800 clusters), and the window capacity scaled with the cluster
# count, 256 -> 16, so that tiles still need several windows (at the
# verify camera a tile of the cut scene sees at most ~50 clusters).
EXPECTED_VISITS_9 = 21967
GRID_7 = 160
CLUSTERS_PER_WINDOW_7 = 16
CLUSTERS_PER_WINDOW_3 = 4
ORBIT_9 = 8
# Kernel-vs-plain rows of the windowed compressed launch: at least this
# many non-empty tiles, the TOP_TILES with the most visits among them.
CHECK_TILES, TOP_TILES = 64, 16
# Bench configs 4, 8 and 10 (bench.py:134-147, :163-198): rings of one
# 80-base-triangle subdiv-1 level-3 icosphere. Config 4's visit pin
# (bench.py:265) and camera distance; the two-level configs' camera
# distance, verify frame (bench.py:510) and orbit length here.
EXPECTED_VISITS_4 = 13338
DIST_4, DIST_8 = 4.5, 6.5
VERIFY_W, VERIFY_H = 480, 288
ORBIT_8 = 8
# Unit visits the plain version may walk in one comparison (it takes 1.5-3.4
# ms per visit on the card, so this stays under a minute): above it the
# comparison takes CHECK_TILES rows.
PLAIN_VISITS = 25000
# Bench config 5 (bench.py:148-162, :669-674, the orbit :676-696): a
# level-5 subdiv-0 icosphere path-traced at 512x512 with 8 sub-cones, 3
# bounces, 2 samples per pixel; the reference's engine gate at 256x256
# (bench.py:543-585), whose budgets are max(64, px/500) pixels over 4/255
# and max(16, px/500) over 0.25, and live counts within 4 per bounce.
PT_SIZE, PT_BOUNCES, PT_SPP, PT_ORBIT, PT_VERIFY = 512, 3, 2, 32, 256
# float32 operations per (ray, leaf) of K2 that the function needs, from
# mt_pair / mt_accept in csrc/group_trace.cu over the q16 table's non-zero
# terms (the ray rows are [d, o x d, o, 1]; the table is [-n | -w1 | -w2 |
# 0] over d, [0 | e2 | -e1 | 0] over o x d, [0 | 0 | 0 | n] over o and
# [0 | 0 | 0 | -e2.w2] over the ones row): det 3 terms (5 ops), u, v and
# the w column 6 terms (11 each), t 3 products and 3 adds (6: the ones
# row needs no product); then one division, four quotients, four window
# compares, one select, one running-minimum compare. The kernel sums the
# same terms (and multiplies the ones row). It counts per (tested lane,
# leaf): the kernel tests only the lanes of the gated sub-groups whose
# running best exceeds t_min (`tests`); the others cannot change. Per
# leaf of a compressed unit visit, from stage_grid_unit: edges 6, three
# cross products 27, e2.w2 5, the w column's non-zero entries 9 ((-n +
# w1) + w2 over d, e1 - e2 over o x d), the normal's norm 7 and
# divisions 3; sign flips and entries that are 0 are not counted.
K2_OPS_PER_RAY_LEAF = 5 + 11 + 11 + 6 + 11 + 1 + 4 + 4 + 1 + 1
K2_DERIVE_OPS_PER_LEAF = 6 + 27 + 5 + 9 + 7 + 3
# K2 unit visits the plain version may walk in one comparison (~2 ms per
# visit on the card); above it the comparison takes CHECK_TILES groups.
PLAIN_VISITS_K2 = 12000
# Frame 0's bounce-1 K2 launch of config 5: (visits, gated sub-groups),
# precomputed and compressed, as every chip run since K2's port counted
# them; the walk is deterministic and the redesign kept it.
K2_PINS = {"config 5": (5144, 16947), "config 5 compressed": (4670, 14313)}
# K2's ms per bounce of frame 0 before the redesign (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6), printed beside this run's.
K2_MS_BEFORE = {"config 5": (6.6740, 5.7714, 3.9459),
                "config 5 compressed": (6.5419,)}
# K1's ms per launch before its redesign (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6), printed beside this run's.
K1_MS_BEFORE = {"config 3": 2.3084, "config 9": 8.2544, "windowed 3": 2.1226,
                "config 7 cut": 11.3229, "config 8": 6.0435,
                "config 10": 13.2461, "config 8 compressed": 4.5239}


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _camera(tb_yaw: float, cfg, dist: float = 3.0):
    from rtmm_tpu_torch.utils import camera
    tb = camera.Trackball()
    tb.set_camera([0.0, 0.0, 0.0],
                  [np.radians(-30.0), np.radians(tb_yaw), 0.0], dist)
    return camera.inv_view_proj(tb, cfg.width, cfg.height)


def _events_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over `rounds` of the mean CUDA-event time of `reps` calls."""
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(card: str, name: str, visits: int, nbytes: int,
           derive: bool) -> tuple[float, str]:
    """Least time for one launch: its fp32 operations (this run's visits;
    with the compressed derive per unit visit) over the fp32 peak, or its
    bytes (each input read once, each output written once) over the HBM
    rate, whichever is larger."""
    ops = visits * TILE_RAYS * OPS_PER_RAY_VISIT
    if derive:
        ops += visits * 64 * DERIVE_OPS_PER_LEAF
    ops_ms = ops / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    _log(f"[bound {name}] {card}: {ops:.4e} fp32 ops ({visits} visits x "
         f"1024 rays x {OPS_PER_RAY_VISIT}"
         + (f" + {visits} x 64 leaves x {DERIVE_OPS_PER_LEAF} derive"
            if derive else "")
         + f") / 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB / "
         f"3.35 TB/s = {bytes_ms:.4f} ms; bound {max(ops_ms, bytes_ms):.4f} "
         f"ms ({by})")
    return max(ops_ms, bytes_ms), by


def _k1_vs_before(card: str, what: str, ms: float,
                  bound: tuple[float, str]) -> None:
    """One K1 launch's ms beside its ms before the redesign, and both
    against this run's bound."""
    before = K1_MS_BEFORE[what]
    _log(f"[{what} K1 vs before] {card}: {ms:.4f} ms per launch, "
         f"{before:.4f} before the redesign ({before / ms:.2f}x); at "
         f"{bound[0] / ms:.3f} of the bound {bound[0]:.4f} ms ({bound[1]}), "
         f"was {bound[0] / before:.3f}")


def _check_rows(ccount, vis) -> list[int]:
    """Rows of a kernel-vs-plain comparison on a subset: the TOP_TILES
    non-empty rows with the most visits, then evenly spaced others up to
    CHECK_TILES."""
    nonempty = (ccount > 0).nonzero()[:, 0]
    order = torch.argsort(vis[nonempty], descending=True, stable=True)
    top = nonempty[order[:TOP_TILES]]
    rest = nonempty[order[TOP_TILES:]]
    step = max(1, len(rest) // max(1, CHECK_TILES - TOP_TILES))
    return sorted(set(top.tolist())
                  | set(rest[::step][:CHECK_TILES - TOP_TILES].tolist()))


def _expect_launches(what: str, expected: dict) -> dict:
    """The launch counts since the last reset; exactly the kernels of
    `expected` must have launched, each as often as given (None: at least
    once)."""
    from rtmm_tpu_torch.ops import group_trace, tile_trace
    got = {k: n for k, n in (*tile_trace.LAUNCHES.items(),
                             *group_trace.LAUNCHES.items()) if n}
    wrong = set(got) != set(expected) or any(
        n is not None and got[k] != n for k, n in expected.items())
    _log(f"[{what}] launches {got}")
    if wrong:
        raise RuntimeError(f"{what}: launches {got}, expected {expected}")
    return got


def _entry(name: str, mode: str, launches: int, err: float, ms: float,
           plain_ms: float, bound: tuple[float, str]) -> dict:
    return {"name": name, "route": "cuda",
            "source": "rtmm_tpu_torch/csrc/tile_trace.cu",
            "replaces": f"rtmm_tpu/ops/pallas_tiled.py:1336 ({mode})",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def _compare_counts(what: str, k_vis, p_vis, k_elig, p_elig, rows=None):
    if rows is not None:
        k_vis, p_vis = k_vis[rows], p_vis[rows]
        k_elig, p_elig = k_elig[rows], p_elig[rows]
    if not (torch.equal(k_vis, p_vis) and torch.equal(k_elig, p_elig)):
        bad = (k_vis != p_vis) | (k_elig != p_elig)
        first = int(bad.nonzero()[0, 0])
        raise RuntimeError(f"{what}: per-tile counts differ on "
                           f"{int(bad.sum())} tiles, first at row {first}")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _window_carry(n_rows: int, dev):
    from rtmm_tpu_torch.ops import tile_trace
    return (torch.full((n_rows, 1024), tile_trace.BIG, device=dev),
            torch.zeros((n_rows, 3, 1024), device=dev),
            torch.zeros(n_rows, dtype=torch.int32, device=dev),
            torch.zeros(n_rows, dtype=torch.int32, device=dev))


def _window_launches(scene, ivp, cfg, kc):
    """Every window launch of one windowed frame, recorded from the
    frame's own window loop: a list of the (args, options) of
    trace_windowed / trace_windowed_plain, the first window first, and
    the visits each window added."""
    from rtmm_tpu_torch.ops import tiled, tile_trace
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivp, cfg)
    meta, tables, opts = tile_trace.scene_tables(scene)
    launches, added = [], []

    def trace_window(ccand, ccount, centry, best_t, rest):
        args = (ccand, ccount, centry, frus, raymat, (best_t, *rest), meta,
                tables, cfg)
        launches.append((args, opts))
        t, n, vis, elig = tile_trace.trace_windowed(*args, **opts)
        added.append(int(vis.sum()) - int(rest[1].sum()))
        return t, (n, vis, elig)

    carry = _window_carry(frus.shape[0], frus.device)
    tiled.trace_windowed_clusters(scene, fi, trace_window, carry[0],
                                  carry[1:], kc)
    return launches, added


def _time_windows(launches) -> float:
    """CUDA-event ms of all of a frame's window launches, replayed."""
    from rtmm_tpu_torch.ops import tile_trace

    def replay():
        for args, opts in launches:
            tile_trace.trace_windowed(*args, **opts)

    replay()
    return _events_ms(replay, reps=3)


def phase_config9(card, ivp, cfg, counted, geo):
    """Config 9 at full size: compressed fused (K1c)."""
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.utils.gate import image_gate

    t0 = time.perf_counter()
    mesh = procedural.make_plane(grid=(160, 160), level=2, amplitude=0.05)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = scene_mod.build_device_scene(mesh, compressed=True,
                                         device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    scene6 = scene_mod.build_device_scene(mesh, device="cuda")
    _log(f"[config 9] {mesh.num_triangles} base triangles, level "
         f"{mesh.max_level}, compressed: U = {scene.num_units} units "
         f"({int(scene.unit_valid.sum())} valid), C = {scene.num_clusters} "
         f"clusters, indexed {scene.indexed}, shared topology "
         f"{scene.unit_gmat is not None}; {scene.device_bytes() / 2**20:.1f} "
         f"MiB on the card (config 6, precomputed: "
         f"{scene6.device_bytes() / 2**20:.1f} MiB); mesh {t_mesh:.1f} s, "
         f"compressed build {t_build:.1f} s")
    ivps = np.stack([_camera(25.0 + 360.0 / ORBIT_9 * k, cfg)
                     for k in range(ORBIT_9)])

    tile_trace.reset_launches()
    img, stats = tile_trace.render_frame(scene, ivp, cfg, with_stats=True)
    orbit = tile_trace.render_frames(scene, ivps, cfg)
    torch.cuda.synchronize()
    launches = counted("tile_trace_fused_compressed")
    _log(f"[config 9 main path] launches of tile_trace_fused_compressed: "
         f"{launches} (1 frame + 1 orbit of {ORBIT_9})")
    if launches != 2:
        raise RuntimeError(f"expected 2 launches, counted {launches}")
    if not (bool(torch.isfinite(orbit).all())
            and tuple(orbit.shape) == (ORBIT_9, HEIGHT, WIDTH, 3)
            and torch.equal(orbit[0], img)):
        raise RuntimeError("config 9: orbit malformed or frame 0 differs")
    nvis = int(stats["kernel_unit_visits"].sum())
    _log(f"[config 9] visits {nvis}, pin {EXPECTED_VISITS_9} (bench.py:268)")
    if abs(nvis - EXPECTED_VISITS_9) > VISITS_RTOL * EXPECTED_VISITS_9:
        raise RuntimeError(f"config 9 visits {nvis} outside 5% of the pin")
    img6, st6 = tile_trace.render_frame(scene6, ivp, cfg, with_stats=True)
    gate6 = image_gate(img, img6)
    _log(f"[config 9 vs config 6] {gate6}; visits config 6 "
         f"{int(st6['kernel_unit_visits'].sum())}")
    if not gate6["ok"]:
        raise RuntimeError(f"config 9 frame fails the gate: {gate6}")

    kc = tile_trace.clusters_per_window(scene, cfg)
    rows = tile_trace.frame_inputs(scene, ivp, cfg, kc)
    meta, tables, opts = tile_trace.scene_tables(scene)
    args = (*rows, meta, tables, cfg)
    k_img, k_vis, k_elig = tile_trace.trace_fused(*args, **opts, **geo)
    (p_img, p_vis, p_elig), plain_ms = _timed(
        lambda: tile_trace.trace_fused_plain(*args, **opts, **geo))
    k_img = k_img[0, :HEIGHT, :WIDTH]
    p_img = p_img[0, :HEIGHT, :WIDTH]
    gate = image_gate(k_img, p_img)
    err = float((k_img - p_img).abs().max())
    _log(f"[config 9 check] kernel vs plain, full frame: {gate}; max |diff| "
         f"{err:.3e}; visits kernel {int(k_vis.sum())} plain "
         f"{int(p_vis.sum())}; eligible kernel {int(k_elig.sum())} plain "
         f"{int(p_elig.sum())}")
    _compare_counts("config 9", k_vis, p_vis, k_elig, p_elig)
    if not gate["ok"] or err > MAX_ABS_ERR or not torch.equal(k_img, img):
        raise RuntimeError("config 9: kernel disagrees with its plain "
                           "version or with the main-path frame")

    def kernel_once():
        tile_trace.trace_fused(*args, **opts, **geo)

    kernel_once()
    kernel_ms = _events_ms(kernel_once, reps=10)

    def orbit_once():
        tile_trace.render_frames(scene, ivps, cfg)

    orbit_once()
    orbit_ms = _events_ms(orbit_once, reps=1, rounds=3) / ORBIT_9
    _log(f"[config 9 time] {card}: kernel {kernel_ms:.4f} ms per 1080p frame "
         f"launch ({WIDTH * HEIGHT / (kernel_ms * 1e-3) / 1e6:.1f} Mrays/s); "
         f"orbit of {ORBIT_9} frames in one launch {orbit_ms:.4f} ms/frame "
         f"({WIDTH * HEIGHT / (orbit_ms * 1e-3) / 1e6:.1f} Mrays/s, prologue "
         f"included); plain version {plain_ms:.1f} ms per frame")
    n_rows = rows[3].shape[0]
    bound = _bound(card, "config 9", int(k_vis.sum()),
                   _nbytes(*rows, meta, tables, opts["corners"])
                   + geo["pw"] * geo["ph"] * 12 + 2 * n_rows * 4, True)
    _k1_vs_before(card, "config 9", kernel_ms, bound)
    return _entry("tile_trace_fused_compressed",
                  "fused, compressed grid_su", launches, err, kernel_ms,
                  plain_ms, bound)


def phase_windowed3(card, scene, ivp, cfg, counted, img_fused,
                    fused_visits):
    """Config 3 in windows of CLUSTERS_PER_WINDOW_3 clusters (K1b)."""
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.utils.gate import image_gate

    cfg_w = dataclasses.replace(
        cfg, kernel_clusters_per_window=CLUSTERS_PER_WINDOW_3)
    tile_trace.reset_launches()
    img, stats = tile_trace.render_frame(scene, ivp, cfg_w, with_stats=True)
    torch.cuda.synchronize()
    launches = counted("tile_trace_windowed")
    windows = stats["windows"]
    _log(f"[windowed 3 main path] launches of tile_trace_windowed: "
         f"{launches} ({windows} windows of {CLUSTERS_PER_WINDOW_3} of "
         f"{scene.num_clusters} clusters)")
    if launches != windows or windows < 2:
        raise RuntimeError(f"windowed config 3: {launches} launches, "
                           f"{windows} windows")
    gate = image_gate(img, img_fused)
    over = int(((img - img_fused).abs().amax(-1) > MAX_ABS_ERR).sum())
    vis = stats["kernel_unit_visits"]
    _log(f"[windowed 3 vs fused] {gate}; {over} pixels over "
         f"{MAX_ABS_ERR:g}; visits windowed "
         f"{int(vis.sum())} fused {int(fused_visits.sum())}; eligible "
         f"windowed {int(stats['kernel_unit_eligible'].sum())}")
    if not torch.equal(vis, fused_visits):
        diff = (vis != fused_visits).nonzero()
        ty, tx = (int(v) for v in diff[0])
        _log(f"[windowed 3 vs fused] per-tile visits differ on {len(diff)} "
             f"tiles; first tile (row {ty}, col {tx}): windowed "
             f"{int(vis[ty, tx])}, fused {int(fused_visits[ty, tx])}")
    else:
        _log("[windowed 3 vs fused] per-tile visits equal on every tile")
    if not gate["ok"] or gate["maxdiff"] > MAX_ABS_ERR:
        raise RuntimeError(f"windowed config 3 frame fails: {gate}")

    launches_w, added = _window_launches(scene, ivp, cfg_w,
                                         CLUSTERS_PER_WINDOW_3)
    _log(f"[windowed 3] visits per window {added}")
    args, opts = launches_w[0]
    k = tile_trace.trace_windowed(*args, **opts)
    p, plain_ms = _timed(lambda: tile_trace.trace_windowed_plain(*args,
                                                                 **opts))
    _compare_counts("windowed config 3", k[2], p[2], k[3], p[3])
    err = max(float((k[0] - p[0]).abs().max()),
              float((k[1] - p[1]).abs().max()))
    _log(f"[windowed 3 check] first window, all {k[0].shape[0]} tiles: "
         f"visits {int(k[2].sum())} equal per tile; max |diff| t and "
         f"normals {err:.3e}")
    if err > MAX_ABS_ERR:
        raise RuntimeError("windowed config 3: kernel disagrees")

    def window_once():
        tile_trace.trace_windowed(*args, **opts)

    window_once()
    kernel_ms = _events_ms(window_once, reps=10)

    def frame_once():
        tile_trace.render_frame(scene, ivp, cfg_w)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=1, rounds=3)
    windows_ms = _time_windows(launches_w)
    _log(f"[windowed 3 time] {card}: first-window launch {kernel_ms:.4f} ms; "
         f"whole windowed frame ({windows} launches, host loop and shading "
         f"included) {frame_ms:.4f} ms, of which its {len(launches_w)} "
         f"window launches, replayed, {windows_ms:.4f} ms; plain first "
         f"window {plain_ms:.1f} ms")
    ccand, ccount, centry, frus, raymat, carry, meta, tables, _ = args
    bound = _bound(card, "windowed 3", int(k[2].sum()),
                   _nbytes(ccand, ccount, centry, frus, raymat, meta, tables)
                   + 2 * _nbytes(*carry), False)
    _k1_vs_before(card, "windowed 3", kernel_ms, bound)
    return _entry("tile_trace_windowed", "windowed, fused=False", launches,
                  err, kernel_ms, plain_ms, bound)


def phase_windowed7(card, ivp, cfg, counted):
    """Config 7's construction at a 160x160 grid: compressed windowed."""
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace

    cfg = dataclasses.replace(
        cfg, kernel_clusters_per_window=CLUSTERS_PER_WINDOW_7)

    t0 = time.perf_counter()
    mesh = procedural.make_plane(grid=(GRID_7, GRID_7), level=3,
                                 amplitude=0.05)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = scene_mod.build_device_scene(mesh, compressed=True,
                                         device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    _log(f"[config 7 cut] grid {GRID_7}x{GRID_7} (config 7: 707x707), "
         f"{CLUSTERS_PER_WINDOW_7} clusters per window (256): "
         f"{mesh.num_triangles} base triangles, level {mesh.max_level}, "
         f"{mesh.num_triangles * 64} micro-triangles; U = {scene.num_units} "
         f"units, C = {scene.num_clusters} clusters; "
         f"{scene.device_bytes() / 2**20:.1f} MiB on the card; mesh "
         f"{t_mesh:.1f} s, build {t_build:.1f} s")

    tile_trace.reset_launches()
    img, stats = tile_trace.render_frame(scene, ivp, cfg, with_stats=True)
    torch.cuda.synchronize()
    launches = counted("tile_trace_windowed_compressed")
    windows = stats["windows"]
    vis = stats["kernel_unit_visits"]
    hit = float((img != torch.tensor(cfg.background, device=img.device))
                .any(-1).float().mean())
    _log(f"[config 7 cut main path] launches of "
         f"tile_trace_windowed_compressed: {launches} ({windows} windows); "
         f"visits {int(vis.sum())}; {hit:.3f} of the pixels hit")
    if launches != windows or windows < 2:
        raise RuntimeError(f"config 7 cut: {launches} launches, {windows} "
                           "windows")
    if not bool(torch.isfinite(img).all()) or hit < 0.05:
        raise RuntimeError("config 7 cut: frame non-finite or empty")

    kc = tile_trace.clusters_per_window(scene, cfg)
    launches_w, added = _window_launches(scene, ivp, cfg, kc)
    _log(f"[config 7 cut] one launch per window; visits per window {added}")
    args, opts = launches_w[0]
    k = tile_trace.trace_windowed(*args, **opts)
    torch.cuda.synchronize()
    nonempty = (args[1] > 0).nonzero()[:, 0]
    rows = _check_rows(args[1], k[2])
    p, plain_ms = _timed(lambda: tile_trace.trace_windowed_plain(
        *args, **opts, rows=rows))
    _compare_counts("config 7 cut", k[2], p[2], k[3], p[3], rows)
    err = max(float((k[0][rows] - p[0][rows]).abs().max()),
              float((k[1][rows] - p[1][rows]).abs().max()))
    _log(f"[config 7 cut check] first window, {len(rows)} of "
         f"{len(nonempty)} non-empty tiles (the {TOP_TILES} with the most "
         f"visits among them): visits {int(k[2][rows].sum())} of "
         f"{int(k[2].sum())} equal per tile; max |diff| t and normals "
         f"{err:.3e}")
    if len(rows) < min(CHECK_TILES, len(nonempty)) or err > MAX_ABS_ERR:
        raise RuntimeError("config 7 cut: kernel disagrees or too few rows")

    def window_once():
        tile_trace.trace_windowed(*args, **opts)

    window_once()
    kernel_ms = _events_ms(window_once, reps=5)

    def frame_once():
        tile_trace.render_frame(scene, ivp, cfg)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=1, rounds=3)
    windows_ms = _time_windows(launches_w)
    _log(f"[config 7 cut time] {card}: first-window launch {kernel_ms:.4f} "
         f"ms; whole windowed frame ({windows} launches, host loop and "
         f"shading included) {frame_ms:.4f} ms "
         f"({WIDTH * HEIGHT / (frame_ms * 1e-3) / 1e6:.1f} Mrays/s), of "
         f"which its {len(launches_w)} window launches, replayed, "
         f"{windows_ms:.4f} ms; plain first window on the {len(rows)} "
         f"checked tiles {plain_ms:.1f} ms")
    ccand, ccount, centry, frus, raymat, carry, meta, tables, _ = args
    bound = _bound(card, "config 7 cut", int(k[2].sum()),
                   _nbytes(ccand, ccount, centry, frus, raymat, meta, tables,
                           opts["corners"]) + 2 * _nbytes(*carry), True)
    _k1_vs_before(card, "config 7 cut", kernel_ms, bound)
    entry = _entry("tile_trace_windowed_compressed",
                   "windowed, compressed grid_su", launches, err, kernel_ms,
                   plain_ms, bound)
    entry["plain_tiles"] = len(rows)
    return entry


def _ring4():
    """Config 4's ring (bench.py:139-144)."""
    from rtmm_tpu_torch.render.instances import Instance
    return [Instance.from_euler(
        [2.4 * np.cos(a), 2.4 * np.sin(a), 0.0], (0.0, a, 0.3 * i), 0.8)
        for i, a in enumerate(2.0 * np.pi * np.arange(6) / 6)]


def _ring(n_inst: int):
    """Config 8's (64, scale 0.35) and config 10's (256, scale 0.18) ring
    (bench.py:175-187)."""
    from rtmm_tpu_torch.render.instances import Instance
    rng = np.random.default_rng(9)
    ring = []
    for i in range(n_inst):
        a = 2.0 * np.pi * i / n_inst
        rad = 2.4 + 0.9 * ((i * 7) % 3)
        ring.append(Instance.from_euler(
            [rad * np.cos(a), rad * np.sin(a),
             0.8 * float(rng.standard_normal())], (0.0, a, 0.2 * i),
            0.35 if n_inst == 64 else 0.18))
    return ring


def _covered(img, cfg) -> float:
    """Fraction of pixels that differ from the miss colour."""
    bg = torch.tensor(cfg.background, device=img.device)
    return float(((img - bg).abs() > 1e-6).any(-1).float().mean())


def phase_config4(card, base, cfg):
    """Config 4: 6 baked instances through the fused kernel (K1a)."""
    from rtmm_tpu_torch.ops import culling, tiled, tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod
    from rtmm_tpu_torch.utils.gate import image_gate

    ring = _ring4()
    ivp = _camera(25.0, cfg, DIST_4)
    baked, bake_ms = _timed(lambda: inst_mod.bake_instances(base, ring))
    _log(f"[config 4] 6 instances baked on the card in {bake_ms:.1f} ms: "
         f"{baked.num_triangles} triangle slots, U = {baked.num_units} "
         f"units, C = {baked.num_clusters} clusters; "
         f"{baked.device_bytes() / 2**20:.2f} MiB baked against "
         f"{base.device_bytes() / 2**20:.2f} MiB shared + 6 x 13 floats")
    tile_trace.reset_launches()
    img, stats = tile_trace.render_frame(baked, ivp, cfg, with_stats=True)
    torch.cuda.synchronize()
    _expect_launches("config 4 baked", {"tile_trace_fused": 1})
    nvis = int(stats["kernel_unit_visits"].sum())
    _log(f"[config 4] visits {nvis}, pin {EXPECTED_VISITS_4} (bench.py:265)")
    if abs(nvis - EXPECTED_VISITS_4) > VISITS_RTOL * EXPECTED_VISITS_4:
        raise RuntimeError(f"config 4 visits {nvis} outside 5% of the pin")
    tile_trace.reset_launches()
    two_level = inst_mod.render_instanced(base, ring, ivp, cfg)
    torch.cuda.synchronize()
    _expect_launches("config 4 two-level", {"tile_trace_raw": 1})
    gate = image_gate(img, two_level)
    _log(f"[config 4] baked vs two-level: {gate}; covered "
         f"{_covered(img, cfg):.4f}")
    if not gate["ok"] or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"config 4 frame fails the gate: {gate}")

    def frame_once():
        tile_trace.render_frame(baked, ivp, cfg)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=5)
    kc = tile_trace.clusters_per_window(baked, cfg)
    rows = tile_trace.frame_inputs(baked, ivp, cfg, kc)
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    geo = dict(tiles_per_frame=tx * ty, tx=tx, pw=pw, ph=ph)

    def kernel_once():
        tile_trace.trace_fused(*rows, baked.cluster_unit_meta, baked.unit_qn,
                               cfg, **geo)

    kernel_once()
    kernel_ms = _events_ms(kernel_once, reps=10)
    _log(f"[config 4 time] {card}: fused kernel {kernel_ms:.4f} ms per frame "
         f"launch ({kernel_ms / nvis * 1e3:.3f} us per visit); whole frame "
         f"with its prologue {frame_ms:.4f} ms "
         f"({cfg.width * cfg.height / (frame_ms * 1e-3) / 1e6:.1f} Mrays/s)")


def _merged_check(card, name, scene, ring, ivp, cfg, img_main):
    """Build one merged frame's launch inputs, hold the raw kernel against
    its plain version on them, and time the launch. Returns (error, kernel
    ms, plain ms, bound, the stages' ms, rows compared)."""
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod

    dev = scene.device
    rot, trn, scl = inst_mod.instance_tensors(ring, dev)
    world = inst_mod.world_frame(ivp, cfg, dev)
    launch = inst_mod.merged_launch_inputs(scene, rot, trn, scl, ivp, world,
                                           cfg)
    meta, tables, opts = tile_trace.scene_tables(scene)
    args = (launch.ccand, launch.ccount, launch.centry, launch.frus, meta,
            tables, cfg)
    footprint = int(launch.n_seen.sum())
    n_rows = launch.frus.shape[0]
    n_over = int(launch.overflow.sum())
    _log(f"[{name}] summed footprint S = {footprint} (instance, tile) pairs "
         f"(max per instance {int(launch.n_seen.max())}); pool {n_rows} rows, "
         f"{int(launch.row_valid.sum())} valid; overflow set: {n_over} "
         f"instances")
    if n_over or int(launch.row_valid.sum()) != footprint:
        raise RuntimeError(f"{name}: the default pool overflowed")
    k_out, k_vis, k_elig = tile_trace.trace_raw(*args, raymat=launch.raymat,
                                                **opts)
    torch.cuda.synchronize()
    nvis = int(k_vis.sum())
    rows = None if nvis <= PLAIN_VISITS else _check_rows(launch.ccount, k_vis)
    (p_out, p_vis, p_elig), plain_ms = _timed(
        lambda: tile_trace.trace_raw_plain(*args, raymat=launch.raymat,
                                           **opts, rows=rows))
    _compare_counts(name, k_vis, p_vis, k_elig, p_elig, rows)
    sel = slice(None) if rows is None else rows
    err_t = float((k_out[sel, 0] - p_out[sel, 0]).abs().max())
    err_n = float((k_out[sel, 1:] - p_out[sel, 1:]).abs().max())
    nonempty = int((launch.ccount > 0).sum())
    _log(f"[{name} check] raw kernel vs plain on "
         f"{nonempty if rows is None else len(rows)} of {nonempty} non-empty "
         f"rows: visits {int(k_vis[sel].sum())} of {nvis} and eligible "
         f"{int(k_elig[sel].sum())} equal per row; max |diff| t {err_t:.3e}, "
         f"normals {err_n:.3e}")
    if max(err_t, err_n) > MAX_ABS_ERR:
        raise RuntimeError(f"{name}: raw kernel disagrees with its plain "
                           "version")
    # The main path's frame is these rows combined and shaded.
    best = inst_mod.combine_rows(k_out, launch, rot, scl,
                                 world.dirs.shape[0])
    again = inst_mod.shade_frame(*best, world, cfg)
    redo = float((again - img_main).abs().max())
    _log(f"[{name} check] main-path frame vs these rows combined and "
         f"shaded: max |diff| {redo:.3e}")
    if redo > MAX_ABS_ERR:
        raise RuntimeError(f"{name}: main-path frame differs")

    def kernel_once():
        tile_trace.trace_raw(*args, raymat=launch.raymat, **opts)

    kernel_once()
    kernel_ms = _events_ms(kernel_once, reps=10)

    def cull_once():
        inst_mod.instance_cull(scene, rot, trn, scl, world)

    def prologue_once():
        w = inst_mod.world_frame(ivp, cfg, dev)
        inst_mod.merged_launch_inputs(scene, rot, trn, scl, ivp, w, cfg)

    def combine_once():
        inst_mod.shade_frame(*inst_mod.combine_rows(
            k_out, launch, rot, scl, world.dirs.shape[0]), world, cfg)

    stages = {}
    for stage, fn in (("per-instance cull", cull_once),
                      ("prologue (world frame, cull, rows, packs, lists)",
                       prologue_once),
                      ("combine + shade", combine_once)):
        fn()
        stages[stage] = _events_ms(fn, reps=5)
    _log(f"[{name} time] {card}: raw launch {kernel_ms:.4f} ms "
         f"({kernel_ms / max(nvis, 1) * 1e3:.3f} us per visit, "
         f"{kernel_ms / n_rows * 1e3:.3f} us per row); stages, each timed "
         "alone: " + "; ".join(f"{k} {v:.4f} ms" for k, v in stages.items())
         + f"; plain version {plain_ms:.1f} ms")
    bound = _bound(card, name, nvis,
                   _nbytes(*args[:4], launch.raymat, meta, tables,
                           opts.get("corners")) + _nbytes(k_out, k_vis,
                                                          k_elig),
                   bool(opts))
    _k1_vs_before(card, name, kernel_ms, bound)
    return (max(err_t, err_n), kernel_ms, plain_ms, bound, stages,
            nonempty if rows is None else len(rows))


def _verify_instanced(name, scene, ring):
    """The instanced image gate of bench.py:495-540: one 480x288 frame
    through the merged launch against the serial per-instance scan.
    Returns the merged frame and its config."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod
    from rtmm_tpu_torch.utils.gate import image_gate

    cfgv = RenderConfig(width=VERIFY_W, height=VERIFY_H)
    ivpv = _camera(25.0, cfgv, DIST_8)
    merged = inst_mod.render_instanced(scene, ring, ivpv, cfgv)
    tile_trace.reset_launches()
    serial, serial_ms = _timed(lambda: inst_mod.render_instanced(
        scene, ring, ivpv, cfgv, serial=True))
    got = {k: n for k, n in tile_trace.LAUNCHES.items() if n}
    gate = image_gate(merged, serial)
    _log(f"[{name} verify] merged vs serial scan at {VERIFY_W}x{VERIFY_H}: "
         f"{gate}; covered_frac {_covered(merged, cfgv):.4f}; the serial "
         f"scan took {serial_ms:.1f} ms on the host's clock, launches {got}")
    if not gate["ok"]:
        raise RuntimeError(f"{name}: merged frame fails the gate: {gate}")
    return merged, cfgv, ivpv


def phase_instanced(card, base, cfg, n_inst: int):
    """Configs 8 and 10: the merged two-level frame (K1d)."""
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod

    name = f"config {8 if n_inst == 64 else 10}"
    ring = _ring(n_inst)
    renderer = inst_mod.InstancedRenderer(base, ring, cfg)
    ivp = _camera(25.0, cfg, DIST_8)
    ivps = [_camera(25.0 + 360.0 / ORBIT_8 * k, cfg, DIST_8)
            for k in range(ORBIT_8)]

    tile_trace.reset_launches()
    img = renderer.render(ivp)
    u8 = renderer.render_u8(ivp)
    orbit = [renderer.render(m) for m in ivps]
    torch.cuda.synchronize()
    launches = _expect_launches(
        f"{name} main path", {"tile_trace_raw": 2 + ORBIT_8})["tile_trace_raw"]
    quant = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    if not (all(bool(torch.isfinite(f).all()) for f in [img, *orbit])
            and tuple(img.shape) == (HEIGHT, WIDTH, 3)
            and u8.shape == (HEIGHT, WIDTH, 3) and u8.dtype == np.uint8
            and np.array_equal(u8, quant.cpu().numpy())
            and torch.equal(orbit[0], img)):
        raise RuntimeError(f"{name}: frames malformed")
    covered = _covered(img, cfg)
    _log(f"[{name} main path] {n_inst} instances, one raw launch per merged "
         f"frame ({launches} frames); frames finite, shapes ok; covered "
         f"fraction at 1080p {covered:.4f}")
    if covered < 0.01:
        raise RuntimeError(f"{name}: frame empty")

    err, kernel_ms, plain_ms, bound, stages, plain_rows = _merged_check(
        card, name, base, ring, ivp, cfg, img)
    verify = _verify_instanced(name, base, ring)

    def frame_once():
        renderer.render(ivp)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=5)

    def orbit_once():
        for m in ivps:
            renderer.render(m)

    orbit_once()
    orbit_ms = _events_ms(orbit_once, reps=1, rounds=3) / ORBIT_8
    cull = stages["per-instance cull"]
    _log(f"[{name} time] {card}: whole merged frame {frame_ms:.4f} ms "
         f"({WIDTH * HEIGHT / (frame_ms * 1e-3) / 1e6:.1f} Mrays/s), of "
         f"which the raw launch {kernel_ms:.4f} ms and the O(N x tiles) "
         f"cull {cull:.4f} ms ({cull / frame_ms:.3f} of the frame); orbit of "
         f"{ORBIT_8} frames {orbit_ms:.4f} ms/frame "
         f"({WIDTH * HEIGHT / (orbit_ms * 1e-3) / 1e6:.1f} Mrays/s)")
    entry = _entry("tile_trace_raw", "raw + xform", launches, err, kernel_ms,
                   plain_ms, bound)
    entry.update(plain_rows=plain_rows, frame_ms=frame_ms,
                 orbit_ms_per_frame=orbit_ms, covered_frac_1080p=covered,
                 instances=n_inst)
    return entry, img, verify


def phase_instanced_compressed(card, mesh, cfg, img8):
    """Config 8 over a compressed base (K1d with the in-kernel derive)."""
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod
    from rtmm_tpu_torch.utils.gate import image_gate

    base_c = scene_mod.build_device_scene(mesh, compressed=True,
                                          device="cuda")
    ring = _ring(64)
    ivp = _camera(25.0, cfg, DIST_8)
    tile_trace.reset_launches()
    img = inst_mod.render_instanced(base_c, ring, ivp, cfg)
    torch.cuda.synchronize()
    launches = _expect_launches(
        "config 8 compressed main path",
        {"tile_trace_raw_compressed": 1})["tile_trace_raw_compressed"]
    gate = image_gate(img, img8)
    _log(f"[config 8 compressed] base {base_c.device_bytes() / 2**20:.2f} "
         f"MiB on the card; frame vs the precomputed base's: {gate}")
    if not gate["ok"] or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"config 8 compressed fails the gate: {gate}")
    err, kernel_ms, plain_ms, bound, _, plain_rows = _merged_check(
        card, "config 8 compressed", base_c, ring, ivp, cfg, img)
    entry = _entry("tile_trace_raw_compressed",
                   "raw + xform, compressed grid_su", launches, err,
                   kernel_ms, plain_ms, bound)
    entry["plain_rows"] = plain_rows
    return entry


def phase_overflow(base, verify):
    """Forced overflow: config 8's ring at the verify size with a pool of
    one row per instance; the backstop re-runs the truncated instances
    through the windowed kernel. verify: config 8's default-pool frame
    at that size (_verify_instanced)."""
    import dataclasses

    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod
    from rtmm_tpu_torch.utils.gate import image_gate

    ring = _ring(64)
    default, cfgv, ivpv = verify
    cfg1 = dataclasses.replace(cfgv, instance_tile_cap=1)
    world = inst_mod.world_frame(ivpv, cfg1, base.device)
    launch = inst_mod.merged_launch_inputs(
        base, *inst_mod.instance_tensors(ring, base.device), ivpv, world,
        cfg1)
    n_over = int(launch.overflow.sum())
    tile_trace.reset_launches()
    capped, ms = _timed(lambda: inst_mod.render_instanced(base, ring, ivpv,
                                                          cfg1))
    got = _expect_launches("forced overflow", {"tile_trace_raw": 1,
                                               "tile_trace_windowed": None})
    gate = image_gate(capped, default)
    _log(f"[forced overflow] pool {launch.frus.shape[0]} rows for S = "
         f"{int(launch.n_seen.sum())}: {n_over} of 64 instances overflow and "
         f"re-run through {got['tile_trace_windowed']} windowed launches; "
         f"frame vs the default pool's: {gate}; {ms:.1f} ms on the host's "
         "clock")
    if not gate["ok"] or n_over == 0 or got["tile_trace_windowed"] < n_over:
        raise RuntimeError(f"forced overflow fails: {gate}")


def phase_raw_raymat(card, scene, ivp, cfg):
    """The raw mode's other ray source, a ray matrix, on config 3: bit for
    bit one windowed launch from fresh carries, and its plain version."""
    from rtmm_tpu_torch.ops import tile_trace

    kc = tile_trace.clusters_per_window(scene, cfg)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivp, cfg)
    lists = tile_trace.cluster_lists(scene, fi, kc)
    meta, tables = scene.cluster_unit_meta, scene.unit_qn
    out, vis, elig = tile_trace.trace_raw(*lists, frus, meta, tables, cfg,
                                          raymat=raymat)
    t, n, vis_w, elig_w = tile_trace.trace_windowed(
        *lists, frus, raymat, _window_carry(frus.shape[0], frus.device),
        meta, tables, cfg)
    torch.cuda.synchronize()
    same = (torch.equal(out[:, 0], t) and torch.equal(out[:, 1:], n)
            and torch.equal(vis, vis_w) and torch.equal(elig, elig_w))
    rows = _check_rows(lists[1], vis)
    (p_out, p_vis, p_elig), plain_ms = _timed(
        lambda: tile_trace.trace_raw_plain(*lists, frus, meta, tables, cfg,
                                           raymat=raymat, rows=rows))
    _compare_counts("raw, ray matrix", vis, p_vis, elig, p_elig, rows)
    err = float((out[rows] - p_out[rows]).abs().max())
    _log(f"[raw, ray matrix, config 3] kc = {kc}, visits {int(vis.sum())}: "
         f"t, normals and counters equal one fresh-carry windowed launch bit "
         f"for bit: {same}; against the plain version on {len(rows)} rows "
         f"({int(vis[rows].sum())} visits, {plain_ms:.1f} ms): counts equal, "
         f"max |diff| {err:.3e}")
    if not same or err > MAX_ABS_ERR:
        raise RuntimeError("raw with a ray matrix disagrees")


# ----------------------------------------------------------------------
# Phases 14-15: the path tracer (config 5) and the grouped trace K2.

@contextlib.contextmanager
def _k2_recording(rec: dict, launches: bool):
    """While active: count the window-loop iterations of
    group_trace.trace_sorted (rec["windows"]), record each call's rays
    (rec["traces"]: (o, d, live, cfg)) and, with launches, each K2
    launch's arguments with the index of its bounce (rec["launches"])."""
    from rtmm_tpu_torch.ops import group_trace
    orig = (group_trace.trace_group, group_trace.trace_sorted,
            group_trace._grouped_cluster_window)
    rec.setdefault("windows", 0)
    rec.setdefault("traces", [])
    rec.setdefault("launches", [])

    def trace_group(*args, **kwargs):
        if launches:
            rec["launches"].append((len(rec["traces"]), args, kwargs))
        return orig[0](*args, **kwargs)

    def trace_sorted(scene, o, d, live, cfg):
        if launches:
            rec["traces"].append((o, d, live, cfg))
        else:
            rec["traces"].append(None)
        return orig[1](scene, o, d, live, cfg)

    def window(*args, **kwargs):
        rec["windows"] += 1
        return orig[2](*args, **kwargs)

    (group_trace.trace_group, group_trace.trace_sorted,
     group_trace._grouped_cluster_window) = trace_group, trace_sorted, window
    try:
        yield rec
    finally:
        (group_trace.trace_group, group_trace.trace_sorted,
         group_trace._grouped_cluster_window) = orig


def _reset_all():
    from rtmm_tpu_torch.ops import group_trace, tile_trace
    tile_trace.reset_launches()
    group_trace.reset_launches()


def _k2_check(card, name, launch, derive):
    """K2 on one recorded launch against its plain version, timed, with
    its bound. Returns a dict: max |diff|, kernel ms, plain ms, bound,
    visits, gated sub-groups, tests (listed lane x unit pairs), groups
    compared."""
    from rtmm_tpu_torch.ops import group_trace
    _, args, kwargs = launch
    k = group_trace.trace_group(*args, **kwargs)
    torch.cuda.synchronize()
    nvis, ngated, ntests = (int(x.sum()) for x in k[2:])
    ccount = args[3]
    groups = (None if nvis <= PLAIN_VISITS_K2
              else _check_rows(ccount, k[2]))
    p, plain_ms = _timed(lambda: group_trace.trace_group_plain(
        *args, **kwargs, groups=groups))
    sel = slice(None) if groups is None else groups
    nonempty = int((ccount > 0).sum())
    n_cmp = nonempty if groups is None else len(groups)
    same_counts = all(torch.equal(k[j][sel], p[j][sel]) for j in (2, 3, 4))
    same_t = torch.equal(k[0][sel], p[0][sel])
    err_t = float((k[0][sel] - p[0][sel]).abs().max())
    err_n = float((k[1][sel] - p[1][sel]).abs().max())
    busy = int(k[2].argmax())
    _log(f"[{name} check] K2 vs plain on {n_cmp} of {nonempty} non-empty "
         f"groups ({args[0].shape[0]} in the launch; the busiest walks "
         f"{int(k[2][busy])} visits, {int(k[4][busy])} tests): visits "
         f"{int(k[2][sel].sum())} of {nvis}, gated sub-groups "
         f"{int(k[3][sel].sum())} of {ngated} and tests "
         f"{int(k[4][sel].sum())} of {ntests} equal per group: "
         f"{same_counts}; t bit-equal: {same_t} (max |diff| {err_t:.3e}); "
         f"normals max |diff| {err_n:.3e} (<= {MAX_ABS_ERR:g}: exact-t "
         "ties sum in another order)")
    if not (same_counts and same_t) or err_n > MAX_ABS_ERR:
        raise RuntimeError(f"{name}: K2 disagrees with its plain version")
    if groups is not None and len(groups) < min(CHECK_TILES, nonempty):
        raise RuntimeError(f"{name}: too few groups compared")

    def kernel_once():
        group_trace.trace_group(*args, **kwargs)

    kernel_once()
    kernel_ms = _events_ms(kernel_once, reps=10)
    nbytes = _nbytes(*args[:10], *(v for v in kwargs.values()
                                   if isinstance(v, torch.Tensor)),
                     *k)
    ops = ntests * 64 * K2_OPS_PER_RAY_LEAF
    if derive:
        ops += nvis * 64 * K2_DERIVE_OPS_PER_LEAF
    ops_ms = ops / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    bound = (max(ops_ms, bytes_ms), by)
    _log(f"[bound {name}] {card}: {ops:.4e} fp32 ops ({ntests} tests x 64 "
         f"leaves x {K2_OPS_PER_RAY_LEAF}"
         + (f" + {nvis} visits x 64 leaves x {K2_DERIVE_OPS_PER_LEAF} derive"
            if derive else "")
         + f") / 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB / "
         f"3.35 TB/s = {bytes_ms:.4f} ms; bound {bound[0]:.4f} ms ({by}); "
         f"K2 {kernel_ms:.4f} ms, at {bound[0] / kernel_ms:.3f} of it")
    return dict(err=max(err_t, err_n), ms=kernel_ms, plain_ms=plain_ms,
                bound=bound, visits=nvis, gated=ngated, tests=ntests,
                groups=n_cmp)


def _k2_frame0(card, name, launches, derive):
    """K2 against its plain version on every launch of frame 0 (one per
    window of each bounce), the bounce-1 counts held to their pins, each
    bounce's K2 ms printed beside the ms before the redesign. Returns the
    checks of the launches and the K2 ms per bounce."""
    checks = []
    for launch in launches:
        c = _k2_check(card, f"{name}, bounce {launch[0]}", launch, derive)
        c["bounce"] = launch[0]
        checks.append(c)
    first = checks[0]
    if first["bounce"] != 1 or (first["visits"], first["gated"]) != \
            K2_PINS[name]:
        raise RuntimeError(f"{name}: bounce-1 visits / gated "
                           f"{first['visits']} / {first['gated']}, pinned "
                           f"{K2_PINS[name]}")
    per_bounce = {}
    for c in checks:
        per_bounce[c["bounce"]] = per_bounce.get(c["bounce"], 0.0) + c["ms"]
    before = K2_MS_BEFORE[name]
    _log(f"[{name} K2 per bounce] {card}: bounce-1 visits / gated "
         f"{first['visits']} / {first['gated']} equal the pin; "
         + "; ".join(f"bounce {b} {v:.4f} ms ("
                     + (f"{before[b - 1]:.4f} before the redesign"
                        if b <= len(before) else "not measured before")
                     + f", tests {sum(c['tests'] for c in checks if c['bounce'] == b)})"
                     for b, v in sorted(per_bounce.items())))
    return checks, [per_bounce[b] for b in sorted(per_bounce)]


def _k2_entry(name, launches, checks, **extra):
    """The kernel-table entry of K2: ms, plain ms and bound of frame 0's
    bounce-1 launch, max |diff| over every launch checked."""
    first = checks[0]
    bound = first["bound"]
    entry = {"name": name, "route": "cuda",
             "source": "rtmm_tpu_torch/csrc/group_trace.cu",
             "replaces": "rtmm_tpu/ops/pallas_grouped.py:686 (_launch, "
                         + ("compressed grid_su)" if "compressed" in name
                            else "precomputed unit_q16)"),
             "launches": launches,
             "max_abs_err": max(c["err"] for c in checks), "ms": first["ms"],
             "plain_ms": first["plain_ms"], "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None,
             "plain_groups": first["groups"], "visits": first["visits"],
             "gated": first["gated"], "tests": first["tests"],
             "bounds_ms_per_bounce": [c["bound"][0] for c in checks]}
    entry.update(extra)
    return entry


def _pt_frames(tracer, ivps, name, kernels):
    """The counted main path of a path-traced configuration: frames
    through PathTracer.render, launches held to one raw launch per frame
    and one K2 launch per window iteration. Returns the (image, stats)
    pairs and the K2 launches."""
    _reset_all()
    rec = {}
    with _k2_recording(rec, launches=False):
        out = [tracer.render(m) for m in ivps]
    torch.cuda.synchronize()
    raw, k2 = kernels
    got = _expect_launches(f"{name} main path",
                           {raw: len(ivps), k2: rec["windows"]})
    for img, st in out:
        live = st["live_rays_per_bounce"]
        if not (bool(torch.isfinite(img).all())
                and tuple(img.shape) == (PT_SIZE, PT_SIZE, 3)
                and bool((live[1:] <= live[:-1]).all()) and live[0] > 0):
            raise RuntimeError(f"{name}: frame malformed or live counts "
                               f"not monotone: {live.tolist()}")
    _log(f"[{name} main path] {len(ivps)} frames: {got[raw]} raw launches, "
         f"{got[k2]} K2 launches = {rec['windows']} window iterations over "
         f"{len(rec['traces'])} bounce traces; frames finite, live counts "
         f"monotone")
    return out, got[k2]


def _frame_stages(tracer, ivp) -> dict:
    """ms of each stage of one path-traced frame (CUDA events, summed
    over bounces)."""
    timings = {}
    tracer.render(ivp, timings=timings)
    torch.cuda.synchronize()
    return {k: sum(s.elapsed_time(e) for s, e in v)
            for k, v in timings.items()}


def _pt_gate(a, b) -> dict:
    """bench.py's config-5 gate between two frames (bench.py:583-584)."""
    from rtmm_tpu_torch.utils.gate import image_gate
    return image_gate(a, b, per=500, big_per=500)


def phase_config5(card):
    """Config 5: the path tracer end to end (K1d primaries, K2 bounces)."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import group_trace, grouped
    from rtmm_tpu_torch.render import pathtrace

    t0 = time.perf_counter()
    mesh = procedural.make_icosphere(subdivisions=0, level=5, amplitude=0.1)
    scene = scene_mod.build_device_scene(mesh, device="cuda")
    torch.cuda.synchronize()
    cfg = RenderConfig(width=PT_SIZE, height=PT_SIZE, sub_frusta=8)
    pt = pathtrace.PathTraceConfig(bounces=PT_BOUNCES,
                                   samples_per_pixel=PT_SPP, ray_chunk=16384)
    tracer = pathtrace.PathTracer(scene, cfg, pt)
    _log(f"[config 5] {mesh.num_triangles} base triangles, level "
         f"{mesh.max_level}: U = {scene.num_units} units, C = "
         f"{scene.num_clusters} clusters; {scene.device_bytes() / 2**20:.2f} "
         f"MiB on the card; bounce t_max {tracer.pt.bounce_t_max:.4f}; "
         f"build {time.perf_counter() - t0:.1f} s")
    ivp = _camera(25.0, cfg)
    ivps = [_camera(25.0 + 360.0 / PT_ORBIT * k, cfg) for k in range(PT_ORBIT)]

    # -- main path, counted ------------------------------------------------
    out, k2_launches = _pt_frames(tracer, [ivp, ivp] + ivps, "config 5",
                                  ("tile_trace_raw", "group_trace"))
    img0, st0 = out[0]
    if not (torch.equal(out[1][0], img0) and torch.equal(out[2][0], img0)):
        raise RuntimeError("config 5: frame 0 is not deterministic")
    live0 = st0["live_rays_per_bounce"].cpu()
    live_orbit = torch.stack([st["live_rays_per_bounce"].cpu()
                              for _, st in out[2:]]).mean(dim=0)
    rays0 = PT_SIZE * PT_SIZE + float(live0[:-1].sum()) * PT_SPP
    rays_orbit = PT_SIZE * PT_SIZE + float(live_orbit[:-1].sum()) * PT_SPP
    _log(f"[config 5] frame 0 live rays per bounce (per sample) "
         f"{live0.tolist()}, extra window passes "
         f"{st0['extra_window_passes_per_bounce'].tolist()}; orbit mean "
         f"{[round(v, 2) for v in live_orbit.tolist()]}; rays traced per "
         f"frame (bench.py:701-708): frame 0 {rays0:.0f}, orbit {rays_orbit:.0f}")

    # -- K2 against its plain version on every launch of frame 0 -----------
    rec = {}
    with _k2_recording(rec, launches=True):
        img_r, _ = tracer.render(ivp)
    torch.cuda.synchronize()
    if not torch.equal(img_r, img0):
        raise RuntimeError("config 5: recorded frame differs")
    checks, k2_per_bounce = _k2_frame0(card, "config 5", rec["launches"],
                                       False)
    first = checks[0]

    # -- the reference's engine gate (bench.py:543-585) ------------------
    cfgv = dataclasses.replace(cfg, width=PT_VERIFY, height=PT_VERIFY)
    ivpv = _camera(25.0, cfgv)
    pv = pathtrace.PathTracer(scene, cfgv, dataclasses.replace(
        pt, engine="pallas"))
    gv = pathtrace.PathTracer(scene, cfgv, dataclasses.replace(
        pt, engine="grouped"))
    a, sa = pv.render(ivpv)
    (b, sb), grouped_frame_ms = _timed(lambda: gv.render(ivpv))
    gate = _pt_gate(a, b)
    dlive = float((sa["live_rays_per_bounce"]
                   - sb["live_rays_per_bounce"]).abs().max())
    _log(f"[config 5 verify] pallas vs grouped engine at {PT_VERIFY}x"
         f"{PT_VERIFY}: {gate}; live {sa['live_rays_per_bounce'].tolist()} "
         f"vs {sb['live_rays_per_bounce'].tolist()} (max |diff| {dlive}); "
         f"grouped overflow {sb['overflow_groups_per_bounce'].tolist()}; the "
         f"grouped frame took {grouped_frame_ms:.1f} ms on the host's clock")
    if not gate["ok"] or dlive > 4:
        raise RuntimeError(f"config 5: engines disagree: {gate}, {dlive}")
    # Does the grouped engine's 96-candidate cut explain the live-count
    # gap? The same frame with every unit a candidate (no overflow).
    capped = grouped.trace_sorted
    grouped.trace_sorted = functools.partial(
        capped, max_group_candidates=scene.num_units)
    try:
        b_all, sb_all = gv.render(ivpv)
    finally:
        grouped.trace_sorted = capped
    dlive_all = float((sa["live_rays_per_bounce"]
                       - sb_all["live_rays_per_bounce"]).abs().max())
    _log(f"[config 5 verify] grouped engine with all {scene.num_units} units "
         f"as candidates: live {sb_all['live_rays_per_bounce'].tolist()} "
         f"(max |diff| to pallas {dlive_all}); overflow "
         f"{sb_all['overflow_groups_per_bounce'].tolist()}; pallas vs it: "
         f"{_pt_gate(a, b_all)}")

    # -- the lane cuts are exact --------------------------------------------
    os.environ["RTMM_PT_CAP"] = "0"
    try:
        img_nc, st_nc = tracer.render(ivp)
    finally:
        del os.environ["RTMM_PT_CAP"]
    caps = pathtrace._cap_schedule(PT_SPP * PT_SIZE * PT_SIZE, "pallas",
                                   PT_BOUNCES)
    same = (torch.equal(img_nc, img0) and torch.equal(
        st_nc["live_rays_per_bounce"], st0["live_rays_per_bounce"]))
    _log(f"[config 5 compaction] cap schedule {caps} against RTMM_PT_CAP=0: "
         f"image and live counts bit-equal: {same}")
    if not same or not all(caps):
        raise RuntimeError("config 5: the lane cuts change the frame")

    # -- timing (CUDA events) -----------------------------------------------
    def frame_once():
        tracer.render(ivp)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=1, rounds=5)

    def orbit_once():
        for m in ivps:
            tracer.render(m)

    orbit_once()
    orbit_ms = _events_ms(orbit_once, reps=1, rounds=2) / PT_ORBIT
    stages = _frame_stages(tracer, ivp)

    o1, d1, l1, cfg_b = rec["traces"][0]
    k2_trace_ms = _events_ms(lambda: group_trace.trace_sorted(
        scene, o1, d1, l1, cfg_b), reps=1, rounds=3)
    grouped.trace_sorted(scene, o1, d1, l1, cfg_b)
    grouped_ms = _events_ms(lambda: grouped.trace_sorted(
        scene, o1, d1, l1, cfg_b), reps=1, rounds=3)
    _log(f"[config 5 time] {card}: frame {frame_ms:.4f} ms "
         f"({rays0 / (frame_ms * 1e-3) / 1e6:.2f} Mrays/s, {PT_SIZE * PT_SIZE / (frame_ms * 1e-3) / 1e6:.2f} Mpx/s); orbit "
         f"of {PT_ORBIT} frames {orbit_ms:.4f} ms/frame "
         f"({rays_orbit / (orbit_ms * 1e-3) / 1e6:.2f} Mrays/s); stages of "
         "one frame (CUDA events): "
         + "; ".join(f"{k} {v:.4f} ms" for k, v in stages.items()))
    _log(f"[config 5 K2] {card}: bounce-1 launch {first['ms']:.4f} ms for "
         f"{first['visits']} visits "
         f"({first['ms'] / max(first['visits'], 1) * 1e3:.3f} us per visit), "
         f"{first['gated']} gated sub-groups, {first['tests']} tests on "
         f"{rec['launches'][0][1][0].shape[0]} groups; K2 per bounce "
         + ", ".join(f"{v:.4f}" for v in k2_per_bounce)
         + f" ms; bounce 1's whole secondary trace (prologue + window loop) "
         f"{k2_trace_ms:.4f} ms; the grouped engine on the same rays "
         f"{grouped_ms:.4f} ms; plain K2 {first['plain_ms']:.1f} ms on "
         f"{first['groups']} groups")
    entry = _k2_entry(
        "group_trace", k2_launches, checks, frame_ms=frame_ms,
        orbit_ms_per_frame=orbit_ms,
        mrays_per_s=rays_orbit / (orbit_ms * 1e-3) / 1e6,
        k2_ms_per_bounce=k2_per_bounce,
        grouped_engine_bounce1_ms=grouped_ms, stages_ms=stages,
        verify=gate)
    return entry, img0, scene.device_bytes(), mesh, cfg, pt, ivp


def phase_config5_compressed(card, mesh, cfg, pt, ivp, img5, bytes5):
    """Config 5 over a compressed scene (RTMM_PT_COMPRESSED=1,
    bench.py:152-156): K1d + K1c primaries, K2 compressed bounces."""
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.render import pathtrace

    scene = scene_mod.build_device_scene(mesh, compressed=True,
                                         device="cuda")
    tracer = pathtrace.PathTracer(scene, cfg, pt)
    _log(f"[config 5 compressed] U = {scene.num_units} units, indexed "
         f"{scene.indexed}: {scene.device_bytes() / 2**20:.2f} MiB on the card "
         f"against {bytes5 / 2**20:.2f} MiB precomputed")
    out, k2_launches = _pt_frames(
        tracer, [ivp, ivp], "config 5 compressed",
        ("tile_trace_raw_compressed", "group_trace_compressed"))
    img, st = out[0]
    gate = _pt_gate(img, img5)
    _log(f"[config 5 compressed] frame vs the precomputed scene's: {gate}; "
         f"live {st['live_rays_per_bounce'].tolist()}")
    if not gate["ok"]:
        raise RuntimeError(f"config 5 compressed fails the gate: {gate}")
    rec = {}
    with _k2_recording(rec, launches=True):
        tracer.render(ivp)
    torch.cuda.synchronize()
    checks, k2_per_bounce = _k2_frame0(card, "config 5 compressed",
                                       rec["launches"], True)
    first = checks[0]

    def frame_once():
        tracer.render(ivp)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=1, rounds=5)
    stages = _frame_stages(tracer, ivp)
    _log(f"[config 5 compressed time] {card}: frame {frame_ms:.4f} ms; "
         "stages of one frame (CUDA events): "
         + "; ".join(f"{k} {v:.4f} ms" for k, v in stages.items())
         + f"; K2 bounce-1 launch {first['ms']:.4f} ms for "
         f"{first['visits']} visits; plain K2 {first['plain_ms']:.1f} ms on "
         f"{first['groups']} groups")
    return _k2_entry("group_trace_compressed", k2_launches, checks,
                     k2_ms_per_bounce=k2_per_bounce, frame_ms=frame_ms,
                     stages_ms=stages,
                     mib=scene.device_bytes() / 2**20,
                     mib_precomputed=bytes5 / 2**20, verify=gate)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import rtmm_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.io import loader
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import _build, culling, tiled, tile_trace
    from rtmm_tpu_torch.render.renderer import FramePipeline, Renderer
    from rtmm_tpu_torch.utils.gate import image_gate

    def counted(kernel: str) -> int:
        """Launches of `kernel` since the last reset; every other kernel
        must not have launched."""
        return _expect_launches(kernel, {kernel: None})[kernel]

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    _log(f"[card] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
         f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    _log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
         f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        _log(f"[ptxas {name}]\n{_build.ptxas_report(name).strip()}")
    bad, n_rcp = tile_trace.reciprocal_check("cuda")
    _log(f"[reciprocal] the tile kernel's branch-free 1/x against 1.0f / x "
         f"on all {n_rcp} float32 inputs in its range: {bad} differ")
    if bad:
        raise RuntimeError("the tile kernel's reciprocal is not exact")
    for name, occ in tile_trace.occupancy().items():
        _log(f"[occupancy {name}] " + ", ".join(f"{k} {v}"
                                                for k, v in occ.items()))

    # -- 2. scene ----------------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/sphere3_l3.gltf"
        loader.save_gltf_bary(procedural.make_icosphere(
            subdivisions=3, level=3, amplitude=0.12), path)
        mesh = loader.load_micromesh(path)
    scene = scene_mod.build_device_scene(mesh, device="cuda")
    torch.cuda.synchronize()
    n_units = int(scene.unit_valid.sum())
    _log(f"[scene] {mesh.num_triangles} base triangles, level "
         f"{mesh.max_level}; U = {scene.num_units} units ({n_units} valid), "
         f"C = {scene.num_clusters} clusters; "
         f"{scene.device_bytes() / 2**20:.1f} MiB on the card; "
         f"build {time.perf_counter() - t0:.1f} s")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    ivp = _camera(25.0, cfg)
    ivps = np.stack([_camera(25.0 + 360.0 / ORBIT_FRAMES * k, cfg)
                     for k in range(ORBIT_FRAMES)])

    # -- 3. main path (counted launches) ---------------------------------
    tile_trace.reset_launches()
    img_main, stats = tile_trace.render_frame(scene, ivp, cfg,
                                              with_stats=True)
    orbit = tile_trace.render_frames(scene, ivps, cfg)
    renderer = Renderer(scene, cfg)
    u8 = [renderer.render_u8(ivps[k]) for k in range(2)]
    pipe = FramePipeline(renderer)
    piped = []
    for k in range(3):
        done = pipe.submit(ivps[k])
        if done is not None:
            piped.append(done)
    piped += list(pipe.drain())
    torch.cuda.synchronize()
    launches = counted("tile_trace_fused")
    _log(f"[main path] launches of tile_trace: {launches} (1 frame + "
         f"1 orbit of {ORBIT_FRAMES} + 2 render_u8 + 3 pipelined)")
    if launches != 7:
        raise RuntimeError(f"expected 7 kernel launches, counted {launches}")
    for name, arr in (("frame", img_main), ("orbit", orbit)):
        if not bool(torch.isfinite(arr).all()):
            raise RuntimeError(f"{name}: non-finite pixels")
    if tuple(orbit.shape) != (ORBIT_FRAMES, HEIGHT, WIDTH, 3):
        raise RuntimeError(f"orbit shape {tuple(orbit.shape)}")
    if not torch.equal(orbit[0], img_main):
        raise RuntimeError("orbit frame 0 differs from the single frame")
    if len(piped) != 3 or any(f.shape != (HEIGHT, WIDTH, 3)
                              or f.dtype != np.uint8 for f in u8 + piped):
        raise RuntimeError("renderer / pipeline frames malformed")
    if not np.array_equal(piped[0], u8[0]):
        raise RuntimeError("pipelined frame 0 differs from render_u8")
    hit_frac = float((np.abs(u8[0].astype(int) - 74).max(-1) > 0).mean())
    _log(f"[main path] frames finite, shapes ok; {hit_frac:.3f} of frame 0 "
         "pixels differ from the background")

    # -- 4. correctness: kernel vs plain on the same inputs ----------------
    kc = tile_trace.clusters_per_window(scene, cfg)
    rows = tile_trace.frame_inputs(scene, ivp, cfg, kc)
    pw, ph = tiled.padded_size(WIDTH, HEIGHT)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    geo = dict(tiles_per_frame=tx * ty, tx=tx, pw=pw, ph=ph)
    args = (*rows, scene.cluster_unit_meta, scene.unit_qn, cfg)
    k_img, k_vis, k_elig = tile_trace.trace_fused(*args, **geo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_img, p_vis, p_elig = tile_trace.trace_fused_plain(*args, **geo)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    k_img = k_img[0, :HEIGHT, :WIDTH]
    p_img = p_img[0, :HEIGHT, :WIDTH]
    gate = image_gate(k_img, p_img)
    max_abs_err = float((k_img - p_img).abs().max())
    nvis = int(k_vis.sum())
    _log(f"[check] kernel vs plain: {gate}; max |diff| {max_abs_err:.3e} "
         f"(tolerance: the two-tier gate, max |diff| <= {MAX_ABS_ERR:g}, and "
         "equal per-tile visit and eligible counts)")
    _log(f"[check] visits kernel {nvis} plain {int(p_vis.sum())}; eligible "
         f"kernel {int(k_elig.sum())} plain {int(p_elig.sum())}; "
         f"pin {EXPECTED_VISITS} (bench.py:264)")
    if not gate["ok"] or max_abs_err > MAX_ABS_ERR:
        raise RuntimeError(f"kernel disagrees with its plain version: {gate}")
    if not (torch.equal(k_vis, p_vis) and torch.equal(k_elig, p_elig)):
        bad = int((k_vis != p_vis).sum())
        raise RuntimeError(f"per-tile counts differ on {bad} tiles")
    if not torch.equal(k_img, img_main) or not torch.equal(
            k_vis.reshape(ty, tx), stats["kernel_unit_visits"]):
        raise RuntimeError("main-path frame differs from the check launch")
    if abs(nvis - EXPECTED_VISITS) > VISITS_RTOL * EXPECTED_VISITS:
        raise RuntimeError(f"visits {nvis} outside 5% of {EXPECTED_VISITS}")

    # -- 5. timing -----------------------------------------------------------
    def kernel_once():
        tile_trace.trace_fused(*args, **geo)

    for _ in range(3):
        kernel_once()
    kernel_ms = _events_ms(kernel_once, reps=20)

    def orbit_once():
        tile_trace.render_frames(scene, ivps, cfg)

    orbit_once()
    orbit_ms = _events_ms(orbit_once, reps=1)
    per_frame = orbit_ms / ORBIT_FRAMES
    mrays = WIDTH * HEIGHT / (per_frame * 1e-3) / 1e6
    # The same orbit's kernel launch alone (its inputs built beforehand):
    # orbit minus this is the prologue's share.
    batch = [torch.cat(parts) for parts in zip(*(
        tile_trace.frame_inputs(scene, ivps[k], cfg, kc)
        for k in range(ORBIT_FRAMES)))]

    def batch_once():
        tile_trace.trace_fused(*batch, scene.cluster_unit_meta,
                               scene.unit_qn, cfg, **geo)

    batch_once()
    batch_ms = _events_ms(batch_once, reps=1)

    ops = nvis * culling.TILE_H * culling.TILE_W * OPS_PER_RAY_VISIT
    n_rows = rows[3].shape[0]
    nbytes = (scene.unit_qn.numel() * 4 + scene.cluster_unit_meta.numel() * 4
              + sum(r.numel() * r.element_size() for r in rows)
              + pw * ph * 3 * 4 + 2 * n_rows * 4)
    ops_ms = ops / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    _log(f"[time] {card}: kernel {kernel_ms:.4f} ms per 1080p frame launch "
         f"({WIDTH * HEIGHT / (kernel_ms * 1e-3) / 1e6:.1f} Mrays/s); "
         f"orbit of {ORBIT_FRAMES} frames in one launch {orbit_ms:.3f} ms "
         f"= {per_frame:.4f} ms/frame ({mrays:.1f} Mrays/s, prologue "
         f"included), of which the kernel launch alone {batch_ms:.3f} ms = "
         f"{batch_ms / ORBIT_FRAMES:.4f} ms/frame; plain version "
         f"{plain_ms:.1f} ms per frame")
    _log(f"[bound] {card}: {ops:.4e} fp32 ops ({nvis} visits x 1024 rays x "
         f"{OPS_PER_RAY_VISIT}) / 67 TFLOP/s = {ops_ms:.4f} ms; "
         f"{nbytes / 1e6:.2f} MB / 3.35 TB/s = {bytes_ms:.4f} ms; bound "
         f"{bound_ms:.4f} ms ({'operations' if ops_ms >= bytes_ms else 'bytes'}); "
         f"kernel at {bound_ms / kernel_ms:.3f} of it")
    _k1_vs_before(card, "config 3", kernel_ms, (bound_ms, "operations"
                                                if ops_ms >= bytes_ms
                                                else "bytes"))

    kernels = [_entry("tile_trace_fused", "fused, in-kernel raygen",
                      launches, max_abs_err, kernel_ms, plain_ms,
                      (bound_ms, "operations" if ops_ms >= bytes_ms
                       else "bytes"))]

    # -- 6. config 9: compressed, fused (K1c) -------------------------------
    kernels.append(phase_config9(card, ivp, cfg, counted, geo))
    # -- 7. windowed walks (K1b) ---------------------------------------------
    kernels.append(phase_windowed3(card, scene, ivp, cfg, counted, img_main,
                                   stats["kernel_unit_visits"]))
    kernels.append(phase_windowed7(card, ivp, cfg, counted))
    # -- 8-13. instancing (K1a baked; K1d merged; K1b backstop) ---------------
    t0 = time.perf_counter()
    mesh1 = procedural.make_icosphere(subdivisions=1, level=3, amplitude=0.12)
    base = scene_mod.build_device_scene(mesh1, device="cuda")
    _log(f"[instancing base] {mesh1.num_triangles} base triangles, level "
         f"{mesh1.max_level}: U = {base.num_units} units, C = "
         f"{base.num_clusters} clusters, {base.device_bytes() / 2**20:.2f} "
         f"MiB on the card; build {time.perf_counter() - t0:.1f} s")
    phase_config4(card, base, cfg)
    entry8, img8, verify8 = phase_instanced(card, base, cfg, 64)
    kernels.append(entry8)
    kernels.append(phase_instanced_compressed(card, mesh1, cfg, img8))
    phase_overflow(base, verify8)
    entry10, _, _ = phase_instanced(card, base, cfg, 256)
    entry8["config10"] = {k: entry10[k] for k in (
        "ms", "plain_ms", "plain_rows", "bound_ms", "frame_ms",
        "orbit_ms_per_frame", "covered_frac_1080p", "max_abs_err")}
    phase_raw_raymat(card, scene, ivp, cfg)
    # -- 14-15. the path tracer: K1d primaries, K2 bounces -------------------
    entry5, img5, bytes5, mesh5, cfg5, pt5, ivp5 = phase_config5(card)
    kernels.append(entry5)
    kernels.append(phase_config5_compressed(card, mesh5, cfg5, pt5, ivp5,
                                            img5, bytes5))
    _log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
