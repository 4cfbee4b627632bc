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
     FramePipeline over 3 frames; each launch's prologue one tile_frusta
     and one cluster_select launch (csrc/prologue.cu);
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
 6b. the batched frame prologue (tile_trace.frames_inputs: one pass over
     every frame of a launch chunk) on the orbits of configs 3 (64 frames:
     two chunks), 9 (K1c), 6 (32 frames at 1080p each) and 1 (256 frames
     at 256x256): its rows bit-equal to per-frame frame_inputs, one fused
     launch per chunk (counted, and one tile_frusta and one
     cluster_select per chunk), every frame equal to render_frame; the
     chunk's prologue kernel launch calls (host events of a torch.profiler
     trace) and peak memory, its ms per frame (host, device queued behind
     a spin) beside the per-frame loop's, the kernel's and the orbit's,
     and the orbit's busy share (its queued device ms over its ms);
 6c. the prologue kernels (csrc/prologue.cu via ops/prologue.py):
     tile_frusta and cluster_select bit for bit against their plain
     versions on config 3's and config 6's 32-frame 1080p chunks, each
     launch's device time (queued behind a spin) beside its wrapper's ms
     per call, its plain version's and its bound; the same checks and
     times on config 7's frusta, cull and first two windows (phase 7c),
     config 8's world frusta, instance cull and merged rows (phase 9) and
     config 5's primary (phase 14);
  7. windowed walks (K1b): (a) config 3 with 4 clusters per window,
     against phase 3's fused frame, and (b) config 7's construction
     (level-3 plane, compressed) cut from a 707x707 to a 160x160 grid
     (800 clusters) and from 256 to 16 clusters per window, both counted,
     kernel vs plain on the first window's launch, timing and bound;
     (c) config 7 at its full size: a 707x707 level-3 plane (999,698 base
     triangles, 64M micro-triangles, 15,621 clusters), compressed, at 1080p
     in windows of the default 256 clusters (K1b + K1c), the mesh and
     build timed; counted, visits within 5% of the pin, the first window
     against its plain version on its most visited tile and evenly spaced
     others within a visit budget, bench.py's verify (the
     frame against the XLA tile backend at 240x136 by 6x6-cell means),
     the frame's time and where it goes; the scene is freed after it;
     (d) bench configs 1, 2 and 11 (a tessellated and a micro-mesh 20-face
     level-2 icosphere at 256x256, a level-5 320-face icosphere at 1080p)
     on the fused path (K1a), counted: visits within 5% of their pins,
     the frame against the XLA tile backend at full size by the pixel
     gate, config 11's launch against its plain version on checked rows;
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
     per frame, one grouped-trace launch (K2) per window of each bounce,
     one pt_primary and 3 pt_bounce launches per frame (csrc/path_shade.cu:
     each the shading, the draw and the next ray of the primaries or of
     a bounce);
     K2 against its plain version on every launch of frame 0 (t, visits,
     gated sub-groups and tests equal, bounce 1's visits and gated held to
     their pins), each bounce's K2 ms beside the ms before the redesign;
     the uniforms of all 524,288 lanes bit-equal to the plain draw for
     bounce 0 (pt_primary) and bounces 1-2 (pt_bounce) and two seeds;
     pt_primary and pt_bounce against their plain versions on every call
     of frame 0 (uniforms, origins, radiance, hit and alive bit for bit,
     directions within 2 ulp of 1), each launch's device time (launches
     queued behind a spin kernel) beside an empty kernel's on the same
     grid (the launch floor), PR 13's pt_shade + pt_spawn ms of the same
     form, its wrapper's time per call, its plain version's and its
     bound; the frame with the kernels against the frame with the plain
     versions (bit for bit, or within config 5's gate; live counts
     equal), the stage ms of both and the frame's kernel launch calls;
     the reference's engine gate (bench.py:543-585: the pallas and grouped
     engines on one 256x256 frame, and the grouped engine once more with
     no candidate cut, to see whether the cut explains a live-count
     difference); the lane cuts against none, bit for bit; frame, orbit,
     stage times, K2's bound over its tests, and the grouped engine's
     trace of the same bounce;
 15. config 5 compressed (K1d + K1c, K2 compressed, pt_primary,
     pt_bounce): counted frames, K2 against its plain version on every
     launch of frame 0 as in phase 14, pt_primary / pt_bounce against
     their plain
     versions on every call of frame 0 and the frame against its plain
     version as in phase 14, the frame within the gate of phase 14's, the
     frame's stage times, MiB of both scenes;
 16. the per-ray reference backend (pipeline "ray") on config 3 at 1080p,
     the scene rebuilt with its hierarchy tables: frame ms (CUDA events
     over 2 calls of the default 8 candidates per ray), Mrays/s, peak
     memory; that frame within the two-tier gate of phase 3's K1a frame
     on the pixels whose rays enter at most 8 triangle AABBs, with no big
     pixel among them and equal there to the exact frame below; then
     with as many candidates as the most AABBs a ray of the frame enters
     (no candidate cut: exact), the frame within the two-tier gate of
     K1a's and the tessellated (-T) scene's per-ray frame against it at
     RMSE <= 1e-3; one chunk's launches and device busy share under
     torch.profiler; no kernel launches;
 17. stats, counted (K1a): the step heatmap at 1080p, collect_frame_stats
     with its own heatmap (traversal_steps_total equal to the heatmap's
     sum), the kernel visits of --stats' path equal to the pin, and a
     torch.profiler trace of one 32-frame orbit with the device's busy
     share of the traced window, in a process of its own (its three
     launches counted there);
 18. the path tracer's perray engine on config 5's scene with its
     hierarchy at phase 14's 256x256 gate frame (pt_primary, pt_bounce;
     counted), against the pallas engine (K1d, K2, pt_primary, pt_bounce;
     counted) within bench.py:583-584's budgets; frame ms;
 19. the debug render on config 3 at 1080p (clean: passes; one NaN planted
     in leaf_verts: FloatingPointError), the scene cache (the second build
     a load, its tables and its K1a frame bit-equal to the first and to
     phase 3's), and the viewer's headless orbit writing 2 frames at
     1080p (K1a, counted);
 20. multi-device rendering (parallel/sharding.py), ranks spawned by
     parallel/launch.py after every kernel is built: config 3 at 1080p in
     windows of 4 clusters through render_tiled_sharded's trace kernel
     (K1b) on (a) a 1x1 mesh over NCCL and (b) a 2x1 mesh over gloo, each
     rank's t, summed normals and visits bit-equal to the single-card
     windowed trace; (c) 1x2 and 2x2 meshes (scene shards, closest-hit
     combine), the rays whose t or normal differs printed and the frame
     within the two-tier gate, each rank's scene MiB; (d) config 9
     compressed on 1x2 (K1b + K1c); (e) the gspmd pipeline on 2x1 against
     the single card's XLA tile frame; (f) the per-ray pipeline on 1x2 at
     480x270 with 23 candidates against the single card's per-ray frame;
     (g) dryrun_multichip(4). Each layout's ms per frame (CUDA events per
     rank, host clock on rank 0) and K1b launches per rank, counted from
     0 in each rank; ranks of gloo worlds share the one card, so their
     times measure overhead, not scaling;
 21. the port's benchmark, rtmm_tpu_torch/bench.py: its default command
     (config 3) in a process of its own, the row's keys bench.py's less
     vs_baseline, its value positive, its visits within 5% of the pin,
     its verify against the XLA tile backend within budget, and each
     stage's launches as expected (one batched fused launch per orbit
     call); then its config 8 (two-level instanced, K1d) and config 5
     (path-traced, K1d, K2, pt_primary and pt_bounce) rows in this process
     with 4-frame orbits, their launches counted from 0 and their
     verifies within budget.

The windowed (7c), instanced (9, 11) and path-traced (14, 15) main
paths also count their tile_frusta and cluster_select launches. The last
lines are the kernel table as JSON (tile_frusta and cluster_select last,
with every case of phase 6c), the card as nvidia-smi reports it, and
{"ok": true, "device": {...}}.
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
# Config 7 at its full size (bench.py:106-111, _million_tri_scene
# :202-230): a 707x707 level-3 plane, compressed, at 1080p in windows of
# the default 256 clusters, and its visit pin (bench.py:267).
GRID_7_FULL = 707
EXPECTED_VISITS_7 = 1041098
# Unit visits config 7's plain check walks: its first window's most
# visited tiles hold up to 256 clusters x 64 units = 16,384 visits each,
# and the plain walk takes 1.2-2.7 ms per visit on the card's hosts, so
# the check takes the most visited tile (11,912 visits at the verify
# camera) and evenly spaced others within this budget (~15-35 s) instead
# of the 16 most visited.
PLAIN_VISITS_7 = 12000
# Bench configs 1, 2 and 11 (bench.py:75-86, :123-131): (icosphere
# arguments, tessellated, width, height, visit pin bench.py:262-263,269).
SMALL_CONFIGS = {
    "config 1": (dict(subdivisions=0, level=2, amplitude=0.1), True,
                 256, 256, 95),
    "config 2": (dict(subdivisions=0, level=2, amplitude=0.1), False,
                 256, 256, 95),
    "config 11": (dict(subdivisions=2, level=5, amplitude=0.1), False,
                  1920, 1080, 9434),
}
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
# Least-time counts of pt_primary / pt_bounce (csrc/path_shade.cu). The
# draw: four Threefry-2x32 blocks of 79 32-bit operations (2 xors for the
# third key word, 2 adds, 20 rounds of add / rotate / xor, 5 key
# injections of 3 adds), g // total and g % total, and the uniforms' xor,
# shift and or (2 x 3): 324. The direction around the normal: the radius,
# angle, cos, sin and height (9), the basis switch (2), two cross products
# (18), the norm (7) and its 3 divisions, the 3 x 5 sum and the uniforms'
# 2 subtractions: 56 float32 operations. Both only on the lanes that
# spawn (hits). The normal's norm, division and flip toward the ray: 19;
# the four lights (4 x 15) and Reinhard (6): 66, on each hit. pt_primary
# per pixel: the normal, the radiance select (3) and the bounce origin
# (3 x 4): 34; per lane the direction select, 3. pt_bounce per lane: the
# hit test (2 compares) and the radiance's two selected products and adds
# (18); with spawn the normal (19), the hit select, the new origin (3 x 4)
# and the direction select (3): 16 more; without it the normal only on
# hits.
PT_DRAW_INT_OPS = 4 * 79 + 2 + 6
PT_DIR_FP_OPS = 9 + 2 + 18 + 7 + 3 + 15 + 2
PT_NORMAL_FP, PT_DIRECT_FP_OPS = 19, 4 * 15 + 6
PT_PIXEL_FP, PT_LANE0_FP = 19 + 3 + 12, 3
PT_BOUNCE_FP_LANE, PT_SPAWN_FP_LANE = 2 + 18, 19 + 16
# Device ms per launch of PR 13's pt_shade + pt_spawn on config 5's frame
# 0, per form of the kernel that replaces them (PERF.md section 6, PR 13
# run 4, NVIDIA H100 80GB HBM3 at 700 W): the primaries 0.005530 +
# 0.007602; bounces 1 and 2 0.004445 + 0.004470 and 0.003582 + 0.003789;
# bounce 3 pt_shade's 0.003427 alone. Printed beside this run's ms.
PT_MS_BEFORE = {"primary": 0.005530 + 0.007602,
                "bounce 1": 0.004445 + 0.004470,
                "bounce 2": 0.003582 + 0.003789,
                "bounce 3": 0.003427}
# 32-bit integer operations per second of an H100 SXM: 64 INT32 lanes per
# SM per clock x 132 SMs x 1.98 GHz (the published peaks list no integer
# rate outside the tensor cores).
PEAK_INT32 = 64 * 132 * 1.98e9
# GPU clock cycles of the spin kernel that _queued_ms queues its timed
# launches behind (~10 ms at 1.98 GHz; the host queues 20 wrapper calls
# in ~1 ms).
SPIN_CYCLES = 20_000_000
# Seeds of the bounce kernels' all-lane draw check.
PT_DRAW_SEEDS = (0, 2**31 - 1)
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


def _budget_rows(ccount, vis, budget: int) -> list[int]:
    """Rows of a kernel-vs-plain comparison under a visit budget: the most
    visited non-empty row, then evenly spaced non-empty rows (up to
    CHECK_TILES in all) whose visits fit the budget."""
    nonempty = (ccount > 0).nonzero()[:, 0]
    top = int(nonempty[torch.argmax(vis[nonempty])])
    rows, total = [top], int(vis[top])
    for t in nonempty[::max(1, len(nonempty) // CHECK_TILES)].tolist():
        if len(rows) < CHECK_TILES and t != top and (
                total + int(vis[t]) <= budget):
            rows.append(t)
            total += int(vis[t])
    return sorted(rows)


def _expect_launches(what: str, expected: dict) -> dict:
    """The launch counts since the last reset; exactly the kernels of
    `expected` must have launched, each as often as given (None: at least
    once), the prologue kernels (tile_frusta, cluster_select) included."""
    from rtmm_tpu_torch.utils import spans
    got = {k: n for k, n in spans.launches().items() if n}
    wrong = set(got) != set(expected) or any(
        n is not None and got[k] != n for k, n in expected.items())
    _log(f"[{what}] launches {got}")
    if wrong:
        raise RuntimeError(f"{what}: launches {got}, expected {expected}")
    return got


def _prologue(frusta, select) -> dict:
    """An expectation's prologue entries: tile_frusta and cluster_select
    launches (None: at least once; 0: none)."""
    return {k: n for k, n in (("tile_frusta", frusta),
                              ("cluster_select", select)) if n != 0}


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
    """Config 9 at full size: compressed fused (K1c). Returns the kernel
    table's entry, the scene and config 6's (the same mesh, precomputed
    tables)."""
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

    _reset_all()
    img, stats = tile_trace.render_frame(scene, ivp, cfg, with_stats=True)
    orbit = tile_trace.render_frames(scene, ivps, cfg)
    torch.cuda.synchronize()
    launches = counted("tile_trace_fused_compressed", 2, 2)
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
                  plain_ms, bound), scene, scene6


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _profiled(fn) -> dict:
    """stats.device_busy of one call of fn under torch.profiler, and
    "launch_calls": the kernel launch calls (cudaLaunchKernel,
    cuLaunchKernel, ...) among the trace's CUDA runtime and driver
    events, a driver call inside a runtime call counted once. Those are
    taken on the host and every trace has held them; on the card's
    machine the device's events of a trace come back offset by
    milliseconds or not at all, the more often the shorter the trace
    (PERF.md section 7), so a count of a call's kernels reads
    launch_calls."""
    from rtmm_tpu_torch.utils import stats
    with tempfile.TemporaryDirectory() as logdir:
        with stats.profiler_trace(logdir):
            fn()
        busy = stats.device_busy(logdir)
        with open(os.path.join(logdir, "trace.json")) as f:
            api = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and "dur" in e
                   and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    runtime = [(e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in api if e["cat"] == "cuda_runtime"]

    def inside_runtime(e):
        return any(tid == e.get("tid") and lo <= float(e["ts"]) <= hi
                   for tid, lo, hi in runtime)

    busy["launch_calls"] = sum(
        1 for e in api if "LaunchKernel" in e.get("name", "")
        and (e["cat"] == "cuda_runtime" or not inside_runtime(e)))
    return busy


def _queued_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time per call of fn, for kernels shorter than their
    wrapper's host work: each round queues `reps` calls behind a spin
    kernel of ~10 ms, so the card runs them back to back, and CUDA events
    time them; median of the rounds. Raises if the spin ended before the
    host had queued every call."""
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        if start.query():
            raise RuntimeError("the card reached the timed calls before "
                               "the host had queued them")
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


# Least-time counts of the prologue kernels (csrc/prologue.cu), float32
# operations. tile_frusta, per corner direction of a tile's sub-cone grid:
# the NDC (2 divisions, 2 products, 2 subtractions), two unprojects (4
# rows of 3 products and 3 sums, 3 divisions: 27 each), the difference
# (3), the norm (5 and a square root) and 3 divisions: 72; per cone plane
# the cross product (9), the corner-sum dot (5), its compare and the sign
# product (4): 18, and per cone the corner sum (9); per frame the apex: 4
# unprojects (108), their NDC (8), 2 differences and w (9), 5 dots (25),
# the denominator and its guard (5), s and t (8), the point (15): 178.
# cluster_select, per (row, cluster) culled: the box relative to the apex
# (6), per plane 3 selects, 3 products, 2 sums and a compare (4 x 9): 42;
# per (apex, cluster) of a list: its distance (3 + 3 subtractions, 3
# maxima, 3 clamps, 3 products, 2 sums and a square root: 18), once per
# apex, since a list's keys depend on the apex only; per cluster a window
# row holds: its window compare (3).
FRUSTA_OPS_CORNER, FRUSTA_OPS_PLANE, FRUSTA_OPS_CONE = 72, 18, 9
FRUSTA_OPS_APEX = 178
SELECT_OPS_CULL, SELECT_OPS_DIST, SELECT_OPS_WINDOW = 42, 18, 3
# name -> the kernel-vs-plain cases of each prologue kernel, in run order.
PROLOGUE_CASES: dict = {"tile_frusta": {}, "cluster_select": {}}
# Device ms per launch of each case before the kernels' redesign: the
# kernels of commit 8415cf6, the mean of two runs of `python3
# tools/prologue_ab.py` on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# section 6), printed beside this run's.
PROLOGUE_MS_BEFORE = {
    "tile_frusta": {
        "config 3 chunk": 0.120283,
        "config 6 chunk": 0.120254,
        "config 7": 0.005965,
        "config 8": 0.005772,
        "config 5 primary": 0.004341,
    },
    "cluster_select": {
        "config 3 chunk": 0.087637,
        "config 6 chunk": 0.866224,
        "config 7 cull": 0.13134,
        "config 7 window 1": 0.508783,
        "config 7 window 2": 0.506851,
        "config 8 instance cull": 0.081329,
        "config 8 rows": 0.00467,
        "config 5 primary cull": 0.003001,
        "config 5 primary lists": 0.004394,
    },
}


def _prologue_bound(kind, args, kw, out, held) -> tuple[float, str, str]:
    """Least time of one prologue launch on these inputs: its bytes (each
    input read once, each output written once) over the HBM rate, or its
    float32 operations over the fp32 peak, the larger; `held` is the
    (row, cluster) pairs the rows hold. A list needs each cluster's
    distance once per apex (its keys depend on the apex only), a window
    one compare per held pair."""
    if kind == "tile_frusta":
        ivp, nsub, nrows = torch.as_tensor(args[0]), args[5], args[6]
        n_frames = ivp.numel() // 16
        rows = out.normals[..., 0, 0].numel()
        corners = (nrows + 1) * (nsub // nrows + 1)
        ops = (rows * (corners * FRUSTA_OPS_CORNER + (nsub + 1)
                       * (4 * FRUSTA_OPS_PLANE + FRUSTA_OPS_CONE))
               + n_frames * FRUSTA_OPS_APEX)
        # With a pack the sub-planes are written once, into the pack
        # (out.sub_normals is a view of it).
        written = (out.apex, out.normals,
                   out.sub_normals if out.frus is None else out.frus)
        nbytes = n_frames * 64 + _nbytes(*written) + (
            24 if out.frus is not None else 0)
        what = f"{rows} tile rows x {corners} corners"
    else:
        apex, planes, lo, hi, valid = args[:5]
        rows = out.ccount.shape[0] if out.ccount is not None else (
            out.any if out.any is not None else out.hit).shape[0]
        n_cl = lo.shape[0]
        culled = rows * n_cl if kw.get("remaining") is None else 0
        dists = apex.shape[0] * n_cl if out.ccount is not None else 0
        compares = held if kw.get("window") else 0
        ops = (culled * SELECT_OPS_CULL + dists * SELECT_OPS_DIST
               + compares * SELECT_OPS_WINDOW)
        nbytes = (_nbytes(apex, planes, lo, hi, valid, kw.get("remaining"),
                          kw.get("row_valid")) + _nbytes(*out))
        what = (f"{rows} rows x {n_cl} clusters, {apex.shape[0]} apexes, "
                f"{held} held")
    ops_ms = ops / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, (
        f"{what}: {ops:.4e} fp32 ops / 67 TFLOP/s = {ops_ms:.6f} ms; "
        f"{nbytes / 1e6:.3f} MB / 3.35 TB/s = {bytes_ms:.6f} ms")


def _prologue_case(card, case: str, kind: str, args, kw=None) -> dict:
    """One prologue kernel on the inputs a path gives it: bit for bit its
    plain version on the same inputs (every output), its device ms per
    launch (20 launches queued behind a spin), its wrapper's ms per call,
    the plain version's ms and the bound. Raises on any difference."""
    from rtmm_tpu_torch.ops import prologue
    kw = dict(kw or {})
    kernel = getattr(prologue, kind)
    plain = getattr(prologue, kind + "_plain")
    k = kernel(*args, **kw)
    torch.cuda.synchronize()
    p = plain(*args, **kw)
    differ = [f for f, a, b in zip(type(k)._fields, k, p)
              if (a is None) != (b is None)
              or (a is not None and not _bit_equal(a, b))]
    if differ:
        raise RuntimeError(f"{kind} on {case}: {differ} differ from the "
                           "plain version")
    err = max([float((a.float() - b.float()).abs().max()) for a, b in
               zip(k, p) if a is not None and a.numel()
               and a.dtype == torch.float32 and bool(torch.isfinite(a).all())]
              or [0.0])
    if kind == "cluster_select":
        held_mask = kw.get("remaining")
        if held_mask is None:
            held_mask = plain(*args, **{**kw, "want_hit": True}).hit
        held = int(held_mask.sum())
    else:
        held = 0
    device_ms = _queued_ms(lambda: kernel(*args, **kw))
    wrapper_ms = _events_ms(lambda: kernel(*args, **kw), reps=20)
    plain_ms = _events_ms(lambda: plain(*args, **kw), reps=1, rounds=3)
    bound_ms, by, detail = _prologue_bound(kind, args, kw, k, held)
    _log(f"[prologue {kind} {case}] {card}: bit-equal to the plain version "
         f"({', '.join(f for f, a in zip(type(k)._fields, k) if a is not None)}"
         f"); device {device_ms:.6f} ms per launch (wrapper "
         f"{wrapper_ms:.4f} ms per call), plain {plain_ms:.4f} ms; bound "
         f"{bound_ms:.6f} ms ({by}: {detail}), at {bound_ms / device_ms:.3f} "
         f"of it")
    res = {"ms": device_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
    before = PROLOGUE_MS_BEFORE[kind].get(case)
    if before is not None:
        _log(f"[prologue {kind} {case} vs before] {card}: {device_ms:.6f} "
             f"ms per launch, {before:.6f} before the redesign "
             f"({before / device_ms:.2f}x); at {bound_ms / device_ms:.3f} "
             f"of the bound {bound_ms:.6f} ms ({by}), was "
             f"{bound_ms / before:.3f}")
    PROLOGUE_CASES[kind][case] = res
    return res


def _prologue_chunk_cases(card, name, scene, cfg, ivps) -> None:
    """tile_frusta and cluster_select on a fused launch chunk's inputs
    (frames_inputs)."""
    from rtmm_tpu_torch.ops import prologue, tiled, tile_trace
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    ivps = torch.as_tensor(ivps, dtype=torch.float32, device=scene.device)
    frusta = (ivps, cfg.width, cfg.height, pw, ph, cfg.sub_frusta,
              cfg.sub_rows)
    _prologue_case(card, name, "tile_frusta", frusta,
                   dict(pack="raygen", scene_aabb=scene.exit_aabb))
    fr = prologue.tile_frusta(*frusta)
    _prologue_case(card, name, "cluster_select", (
        fr.apex, fr.normals.reshape(-1, 4, 3), scene.cluster_aabb_min,
        scene.cluster_aabb_max, scene.cluster_valid,
        tile_trace.clusters_per_window(scene, cfg)),
        dict(rows_per_apex=fr.normals.shape[1]))


def _prologue_frame_cases(card, name, scene, ivp, cfg, windows=0) -> None:
    """The ray-matrix frame's prologue (ray_frame_inputs: the frusta with
    the pack, the cull) and its lists (cluster_lists), or its first
    `windows` cluster windows."""
    from rtmm_tpu_torch.ops import prologue, tiled, tile_trace
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    ivp = torch.as_tensor(ivp, dtype=torch.float32, device=scene.device)
    frusta = (ivp, cfg.width, cfg.height, pw, ph, cfg.sub_frusta,
              cfg.sub_rows)
    _prologue_case(card, name, "tile_frusta", frusta,
                   dict(pack="plain", scene_aabb=scene.exit_aabb))
    fr = prologue.tile_frusta(*frusta)
    n_tiles = fr.normals.shape[0]
    boxes = (scene.cluster_aabb_min, scene.cluster_aabb_max)
    _prologue_case(card, f"{name} cull", "cluster_select", (
        fr.apex[None], fr.normals, *boxes, scene.cluster_valid, 0),
        dict(rows_per_apex=n_tiles, want_hit=True))
    hit = prologue.cluster_select(
        fr.apex[None], fr.normals, *boxes, scene.cluster_valid, 0,
        rows_per_apex=n_tiles, want_hit=True).hit
    kc = tile_trace.clusters_per_window(scene, cfg)
    if not windows:
        _prologue_case(card, f"{name} lists", "cluster_select", (
            fr.apex[None], None, *boxes, None, kc),
            dict(remaining=hit, rows_per_apex=n_tiles))
        return
    remaining = hit & hit.any(dim=1)[:, None]
    for w in range(windows):
        kw = dict(remaining=remaining, rows_per_apex=n_tiles, window=True)
        _prologue_case(card, f"{name} window {w + 1}", "cluster_select", (
            fr.apex[None], None, *boxes, None, kc), kw)
        remaining = prologue.cluster_select(
            fr.apex[None], None, *boxes, None, kc, **kw).new_remaining


def _prologue_instanced_cases(card, name, scene, ring, ivp, cfg) -> None:
    """The merged launch's prologue: the world frusta (world_frame), the
    (instance, tile) cull (instance_cull) and the rows' lists
    (merged_launch_inputs)."""
    from rtmm_tpu_torch.ops import tiled, tile_trace
    from rtmm_tpu_torch.render import instances as inst_mod
    dev = scene.device
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    _prologue_case(card, name, "tile_frusta", (
        torch.as_tensor(ivp, dtype=torch.float32, device=dev), cfg.width,
        cfg.height, pw, ph, cfg.sub_frusta, cfg.sub_rows))
    rot, trn, scl = inst_mod.instance_tensors(ring, dev)
    world = inst_mod.world_frame(ivp, cfg, dev)
    _, apex_o, normals_o, _ = inst_mod.instance_cull(scene, rot, trn, scl,
                                                     world)
    launch = inst_mod.merged_launch_inputs(scene, rot, trn, scl, ivp, world,
                                           cfg)
    boxes = (scene.cluster_aabb_min, scene.cluster_aabb_max,
             scene.cluster_valid)
    _prologue_case(card, f"{name} instance cull", "cluster_select", (
        apex_o, normals_o.reshape(-1, 4, 3), *boxes, 0),
        dict(rows_per_apex=normals_o.shape[1], want_any=True))
    _prologue_case(card, f"{name} rows", "cluster_select", (
        apex_o[launch.row_inst], normals_o[launch.row_inst, launch.row_tile],
        *boxes, tile_trace.clusters_per_window(scene, cfg)),
        dict(row_valid=launch.row_valid))


def _prologue_entries(launches: dict) -> list:
    """The kernel line's entries of the two prologue kernels: launches
    from the main path, the numbers from config 3's chunk (the main
    path's shapes), every case beside them."""
    replaces = {
        "tile_frusta": "rtmm_tpu/ops/culling.py:56 (tile_frustums), :159 "
                       "(tile_sub_frustums); rtmm_tpu/ops/tiled.py:291 "
                       "(frustum_scalars): XLA-fused, no Pallas kernel "
                       "behind it",
        "cluster_select": "rtmm_tpu/ops/culling.py:207 (cull_units), :219 "
                          "(aabb_distance); rtmm_tpu/ops/tiled.py:193 "
                          "(_select_nearest_clusters, top_k), "
                          "rtmm_tpu/ops/pallas_tiled.py:1503: XLA-fused, "
                          "no Pallas kernel behind it"}
    out = []
    for kind in ("tile_frusta", "cluster_select"):
        main = PROLOGUE_CASES[kind]["config 3 chunk"]
        out.append({"name": kind, "route": "cuda",
                    "source": "rtmm_tpu_torch/csrc/prologue.cu",
                    "replaces": replaces[kind],
                    "launches": launches[kind],
                    "max_abs_err": max(c["max_abs_err"] for c in
                                       PROLOGUE_CASES[kind].values()),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": None,
                    "wrapper_ms": main["wrapper_ms"],
                    "cases": PROLOGUE_CASES[kind]})
    return out


def phase_prologue_kernels(card, scenes, cfg) -> None:
    """The two prologue kernels against their plain versions, bit for bit,
    on the fused launch chunks of configs 3 (20 clusters) and 6 (200
    clusters): 32 frames at 1080p, the bench's chunk."""
    for name in ("config 3", "config 6"):
        ivps = np.stack([_camera(25.0 + 360.0 / ORBIT_FRAMES * k, cfg)
                         for k in range(ORBIT_FRAMES)])
        _prologue_chunk_cases(card, f"{name} chunk", scenes[name], cfg, ivps)


def _batched_prologue(card, name, scene, cfg, ivps, kernel) -> dict:
    """One configuration's orbit through the batched prologue: its rows
    bit-equal to per-frame frame_inputs, one fused launch per chunk, each
    frame equal to render_frame; the chunk's prologue kernel launch calls,
    peak memory and ms per frame beside the per-frame loop's, the kernel's
    and the orbit's, and the orbit's busy share: its device ms, queued
    behind a spin, over its ms."""
    from rtmm_tpu_torch.ops import prologue as prologue_kernels
    from rtmm_tpu_torch.ops import tiled, tile_trace

    n = len(ivps)
    ivps = torch.as_tensor(ivps, dtype=torch.float32, device=scene.device)
    kc = tile_trace.clusters_per_window(scene, cfg)
    f = tile_trace.frames_per_launch(cfg, n)
    chunk = ivps[:f]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    chunk_rows = tile_trace.frames_inputs(scene, chunk, cfg, kc)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    rows = tile_trace.frames_inputs(scene, ivps, cfg, kc)
    per = [torch.cat(parts) for parts in zip(*(
        tile_trace.frame_inputs(scene, ivps[k], cfg, kc) for k in range(n)))]
    differ = [nm for nm, a, b in zip(("ccand", "ccount", "centry", "frus"),
                                     rows, per) if not _bit_equal(a, b)]
    if differ:
        raise RuntimeError(f"{name}: the batched prologue's {differ} differ "
                           "from the per-frame rows")

    _reset_all()
    orbit = tile_trace.render_frames(scene, ivps, cfg)
    torch.cuda.synchronize()
    _expect_launches(f"{name} orbit of {n}", {
        kernel: n // f, "tile_frusta": n // f, "cluster_select": n // f})
    for k in range(n):
        if not torch.equal(orbit[k],
                           tile_trace.render_frame(scene, ivps[k], cfg)):
            raise RuntimeError(f"{name}: orbit frame {k} differs from "
                               "render_frame")
    del orbit

    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    geo = dict(tiles_per_frame=(pw // 32) * (ph // 32), tx=pw // 32, pw=pw,
               ph=ph)
    meta, tables, opts = tile_trace.scene_tables(scene)

    def prologue():
        tile_trace.frames_inputs(scene, chunk, cfg, kc)

    def per_frame():
        for k in range(f):
            tile_trace.frame_inputs(scene, chunk[k], cfg, kc)

    def launch():
        tile_trace.trace_fused(*chunk_rows, meta, tables, cfg, **opts, **geo)

    def orbit_once():
        tile_trace.render_frames(scene, ivps, cfg)

    def traced_launches(fn):
        """Kernel launch calls in a profiler trace of one call of fn, and
        the prologue kernels' launches counted in that call."""
        before = sum(prologue_kernels.LAUNCHES.values())
        calls = _profiled(fn)["launch_calls"]
        return calls, sum(prologue_kernels.LAUNCHES.values()) - before

    events, own = traced_launches(prologue)
    events_1, own_1 = traced_launches(lambda: tile_trace.frames_inputs(
        scene, chunk[:1], cfg, kc))
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prologue()
        host.append((time.perf_counter() - t0) * 1e3)
    for fn in (prologue, per_frame, launch, orbit_once):
        fn()
    orbit_ms = _events_ms(orbit_once, reps=1)
    orbit_device_ms = _queued_ms(orbit_once, reps=1, rounds=3)
    res = {"frames": n, "frames_per_launch": f, "launches": n // f,
           "prologue_events_per_chunk": events,
           "prologue_events_one_frame": events_1,
           "prologue_peak_mib": peak_mib,
           "prologue_ms_per_frame": _events_ms(prologue, reps=1) / f,
           "prologue_host_ms_per_frame": statistics.median(host) / f,
           "prologue_device_ms_per_frame": _queued_ms(prologue,
                                                      reps=10) / f,
           "per_frame_loop_ms_per_frame": _events_ms(per_frame, reps=1,
                                                     rounds=3) / f,
           "kernel_ms_per_frame": _events_ms(launch, reps=1) / f,
           "orbit_ms_per_frame": orbit_ms / n,
           "orbit_device_ms_per_frame": orbit_device_ms / n,
           "orbit_busy_share": orbit_device_ms / orbit_ms}
    mrays = cfg.width * cfg.height / (res["orbit_ms_per_frame"] * 1e-3) / 1e6
    _log(f"[batched prologue {name}] {card}: {n} frames at {cfg.width}x"
         f"{cfg.height}, C = {scene.num_clusters}, {n // f} launch(es) of "
         f"{f} frames ({kernel}); rows bit-equal to per-frame frame_inputs "
         f"({rows[0].shape[0]} rows: ccand, ccount, centry, frus); every "
         f"frame equal to render_frame. Chunk prologue: {events} kernel "
         f"launch calls in its profiler trace ({events_1} for one frame "
         f"alone), peak memory {peak_mib:.1f} MiB, "
         f"{res['prologue_ms_per_frame']:.4f} ms/frame (host "
         f"{res['prologue_host_ms_per_frame']:.4f}, device "
         f"{res['prologue_device_ms_per_frame']:.4f} queued; per-frame loop "
         f"{res['per_frame_loop_ms_per_frame']:.4f}); kernel "
         f"{res['kernel_ms_per_frame']:.4f} ms/frame; orbit "
         f"{res['orbit_ms_per_frame']:.4f} ms/frame ({mrays:.1f} Mrays/s), "
         f"device {res['orbit_device_ms_per_frame']:.4f} ms/frame queued: "
         f"busy share {res['orbit_busy_share']}")
    if not own or events < own or events_1 < own_1:
        raise RuntimeError(f"{name}: the profiler traces hold {events} and "
                           f"{events_1} kernel launch calls, the prologue "
                           f"kernels counted {own} and {own_1}")
    if not res["orbit_busy_share"] > 0.0:
        raise RuntimeError(f"{name}: the orbit's busy share is "
                           f"{res['orbit_busy_share']}")
    return res


def phase_batched_prologue(card, scenes, cfg) -> dict:
    """The batched frame prologue (tile_trace.frames_inputs) on the fused
    orbits of bench configs 3 (in two launch chunks), 9 (K1c), 6 and 1 at
    their bench sizes and frames per call."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod

    def orbit(n, c):
        return np.stack([_camera(25.0 + 360.0 / n * k, c) for k in range(n)])

    out = {}
    for name, n, kernel in (("config 3", 2 * ORBIT_FRAMES, "tile_trace_fused"),
                            ("config 9", ORBIT_FRAMES,
                             "tile_trace_fused_compressed"),
                            ("config 6", ORBIT_FRAMES, "tile_trace_fused")):
        out[name] = _batched_prologue(card, name, scenes[name], cfg,
                                      orbit(n, cfg), kernel)
    kw, tess, w, h, _ = SMALL_CONFIGS["config 1"]
    scene1 = scene_mod.build_device_scene(procedural.make_icosphere(**kw),
                                          tessellated=tess, device="cuda")
    cfg1 = RenderConfig(width=w, height=h)
    out["config 1"] = _batched_prologue(card, "config 1", scene1, cfg1,
                                        orbit(256, cfg1), "tile_trace_fused")
    return out


def phase_windowed3(card, scene, ivp, cfg, counted, img_fused,
                    fused_visits):
    """Config 3 in windows of CLUSTERS_PER_WINDOW_3 clusters (K1b)."""
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.utils.gate import image_gate

    cfg_w = dataclasses.replace(
        cfg, kernel_clusters_per_window=CLUSTERS_PER_WINDOW_3)
    _reset_all()
    img, stats = tile_trace.render_frame(scene, ivp, cfg_w, with_stats=True)
    torch.cuda.synchronize()
    windows = stats["windows"]
    launches = counted("tile_trace_windowed", 1, 1 + windows)
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

    _reset_all()
    img, stats = tile_trace.render_frame(scene, ivp, cfg, with_stats=True)
    torch.cuda.synchronize()
    windows = stats["windows"]
    launches = counted("tile_trace_windowed_compressed", 1, 1 + windows)
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


def _gated_verify(scene, cfg, n_units):
    """bench.py's verification of a frame (_verify_image): the kernel
    frame against the XLA tile backend at bench's verify size, with the
    pixel or the cell tier by bench's rule. Returns (gate, mode, (vw, vh),
    kernel frame ms, reference ms)."""
    from rtmm_tpu_torch.ops import tiled, tile_trace
    from rtmm_tpu_torch.utils.gate import cell_gate, image_gate, verify_plan

    vw, vh, mode = verify_plan(n_units, cfg.width, cfg.height)
    cfg_v = dataclasses.replace(cfg, width=vw, height=vh)
    ivp_v = _camera(25.0, cfg_v)
    a, a_ms = _timed(lambda: tile_trace.render_frame(scene, ivp_v, cfg_v))
    b, b_ms = _timed(lambda: tiled.render_tiled(scene, ivp_v, cfg_v))
    gate = (cell_gate if mode == "cell" else image_gate)(a, b)
    return gate, mode, (vw, vh), a_ms, b_ms


def phase_config7(card, ivp, cfg, counted):
    """Config 7 at full size: a 707x707 level-3 plane (10^6 base
    triangles, 64M micro-triangles), compressed, at 1080p in windows of
    the default 256 clusters (K1b + K1c). Returns the kernel table's
    entry; the scene goes with the phase's locals."""
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace

    t0 = time.perf_counter()
    mesh = procedural.make_plane(grid=(GRID_7_FULL, GRID_7_FULL), level=3,
                                 amplitude=0.05)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = scene_mod.build_device_scene(mesh, compressed=True,
                                         device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_tri = mesh.num_triangles
    del mesh
    n_units = int(scene.unit_valid.sum())
    kc = tile_trace.clusters_per_window(scene, cfg)
    _log(f"[config 7] grid {GRID_7_FULL}x{GRID_7_FULL}: {n_tri} base "
         f"triangles, level 3, {n_tri * 64} micro-triangles, compressed; "
         f"U = {scene.num_units} units ({n_units} valid), C = "
         f"{scene.num_clusters} clusters, {kc} clusters per window; "
         f"{scene.device_bytes() / 2**20:.1f} MiB on the card; mesh "
         f"{t_mesh:.1f} s, build {t_build:.1f} s (together "
         f"{t_mesh + t_build:.1f} s)")

    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    (img, stats), first_ms = _timed(lambda: tile_trace.render_frame(
        scene, ivp, cfg, with_stats=True))
    windows = stats["windows"]
    launches = counted("tile_trace_windowed_compressed", 1, 1 + windows)
    nvis = int(stats["kernel_unit_visits"].sum())
    hit = float((img != torch.tensor(cfg.background, device=img.device))
                .any(-1).float().mean())
    _log(f"[config 7 main path] launches of tile_trace_windowed_compressed: "
         f"{launches} ({windows} windows); visits {nvis}, pin "
         f"{EXPECTED_VISITS_7} (bench.py:267); {hit:.3f} of the pixels hit; "
         f"first frame {first_ms:.1f} ms; peak "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the card")
    if launches != windows or windows < 1:
        raise RuntimeError(f"config 7: {launches} launches, {windows} "
                           "windows")
    if not bool(torch.isfinite(img).all()) or hit < 0.05:
        raise RuntimeError("config 7: frame non-finite or empty")
    if abs(nvis - EXPECTED_VISITS_7) > VISITS_RTOL * EXPECTED_VISITS_7:
        raise RuntimeError(f"config 7 visits {nvis} outside 5% of the pin")

    launches_w, added = _window_launches(scene, ivp, cfg, kc)
    _log(f"[config 7] visits per window {added}")
    args, opts = launches_w[0]
    k = tile_trace.trace_windowed(*args, **opts)
    torch.cuda.synchronize()
    nonempty = (args[1] > 0).nonzero()[:, 0]
    rows = _budget_rows(args[1], k[2], PLAIN_VISITS_7)
    p, plain_ms = _timed(lambda: tile_trace.trace_windowed_plain(
        *args, **opts, rows=rows))
    _compare_counts("config 7", k[2], p[2], k[3], p[3], rows)
    err = max(float((k[0][rows] - p[0][rows]).abs().max()),
              float((k[1][rows] - p[1][rows]).abs().max()))
    _log(f"[config 7 check] first window, {len(rows)} of {len(nonempty)} "
         f"non-empty tiles (the most visited, {int(k[2].max())} visits, and "
         f"evenly spaced others within {PLAIN_VISITS_7} visits): visits "
         f"{int(k[2][rows].sum())} of {int(k[2].sum())} equal per tile; max "
         f"|diff| t and normals {err:.3e}; plain {plain_ms:.1f} ms")
    if len(rows) < min(4, len(nonempty)) or err > MAX_ABS_ERR:
        raise RuntimeError("config 7: kernel disagrees or too few rows")
    _prologue_frame_cases(card, "config 7", scene, ivp, cfg, windows=2)

    gate, mode, (vw, vh), k_ms, ref_ms = _gated_verify(scene, cfg, n_units)
    _log(f"[config 7 verify] {card}: bench.py's verify at {vw}x{vh}, {mode} "
         f"tier: kernel frame vs the XLA tile backend {gate}; kernel frame "
         f"{k_ms:.1f} ms, XLA tile backend {ref_ms:.1f} ms (host clock)")
    if mode != "cell" or not gate["ok"]:
        raise RuntimeError(f"config 7 verify fails: {mode} {gate}")

    def window_once():
        tile_trace.trace_windowed(*args, **opts)

    window_once()
    kernel_ms = _events_ms(window_once, reps=3)

    def frame_once():
        tile_trace.render_frame(scene, ivp, cfg)

    frame_once()
    frame_ms = _events_ms(frame_once, reps=1, rounds=3)
    prologue_ms = _events_ms(
        lambda: tile_trace.ray_frame_inputs(scene, ivp, cfg), reps=1,
        rounds=3)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivp, cfg)
    loop_ms = _events_ms(lambda: tile_trace.trace_windows(
        scene, fi, frus, raymat, cfg, kc), reps=1, rounds=3)
    _, loop_host_ms = _timed(lambda: tile_trace.trace_windows(
        scene, fi, frus, raymat, cfg, kc))
    windows_ms = _time_windows(launches_w)
    _log(f"[config 7 time] {card}: whole frame {frame_ms:.4f} ms "
         f"({WIDTH * HEIGHT / (frame_ms * 1e-3) / 1e6:.2f} Mrays/s); "
         f"prologue (rays, frusta, {scene.num_clusters}-cluster cull) "
         f"{prologue_ms:.4f} ms; window loop {loop_ms:.4f} ms (host clock "
         f"{loop_host_ms:.4f} ms), of which its {len(launches_w)} launches, "
         f"replayed, {windows_ms:.4f} ms (the rest: cluster selection and "
         f"one host sync per window); shading the rest; first-window "
         f"launch {kernel_ms:.4f} ms")
    ccand, ccount, centry, frus_a, raymat_a, carry, meta, tables, _ = args
    bound = _bound(card, "config 7", int(k[2].sum()),
                   _nbytes(ccand, ccount, centry, frus_a, raymat_a, meta,
                           tables, opts["corners"]) + 2 * _nbytes(*carry),
                   True)
    _log(f"[config 7 K1] {card}: first-window launch {kernel_ms:.4f} ms at "
         f"{bound[0] / kernel_ms:.3f} of its bound {bound[0]:.4f} ms "
         f"({bound[1]}); {windows} windows per frame")
    entry = _entry("tile_trace_windowed_compressed",
                   "windowed, compressed grid_su", launches, err, kernel_ms,
                   plain_ms, bound)
    entry.update(config="7 full", plain_tiles=len(rows), windows=windows,
                 visits=nvis, frame_ms=frame_ms, prologue_ms=prologue_ms,
                 loop_ms=loop_ms, windows_ms=windows_ms,
                 mesh_s=t_mesh, build_s=t_build, verify=gate)
    return entry


def phase_small_configs(card, counted) -> dict:
    """Bench configs 1, 2 and 11 on the fused path (K1a): visits against
    their pins, the frame against the XLA tile backend at full size, and
    config 11's launch against its plain version on checked rows."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace

    out = {}
    for name, (kw, tess, w, h, pin) in SMALL_CONFIGS.items():
        mesh = procedural.make_icosphere(**kw)
        scene = scene_mod.build_device_scene(mesh, tessellated=tess,
                                             device="cuda")
        n_units = int(scene.unit_valid.sum())
        cfg = RenderConfig(width=w, height=h)
        ivp = _camera(25.0, cfg)
        _reset_all()
        img, stats = tile_trace.render_frame(scene, ivp, cfg,
                                             with_stats=True)
        torch.cuda.synchronize()
        launches = counted("tile_trace_fused", 1, 1)
        nvis = int(stats["kernel_unit_visits"].sum())
        _log(f"[{name}] {mesh.num_triangles} base triangles, level "
             f"{mesh.max_level}{', tessellated' if tess else ''}: U = "
             f"{scene.num_units} units, C = {scene.num_clusters} clusters; "
             f"{w}x{h}; launches of tile_trace_fused {launches}; visits "
             f"{nvis}, pin {pin}")
        if launches != 1 or stats["windows"] != 1:
            raise RuntimeError(f"{name}: {launches} launches")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"{name}: non-finite pixels")
        if abs(nvis - pin) > VISITS_RTOL * pin:
            raise RuntimeError(f"{name} visits {nvis} outside 5% of {pin}")
        gate, mode, size, _, ref_ms = _gated_verify(scene, cfg, n_units)
        _log(f"[{name} verify] bench.py's verify at {size[0]}x{size[1]}, "
             f"{mode} tier: kernel frame vs the XLA tile backend {gate}; "
             f"XLA tile backend {ref_ms:.1f} ms (host clock)")
        if mode != "pixel" or size != (w, h) or not gate["ok"]:
            raise RuntimeError(f"{name} verify fails: {mode} {size} {gate}")
        res = {"visits": nvis, "launches": launches, "verify": gate}
        if name == "config 11":
            res["max_abs_err"], res["plain_ms"] = _fused_rows_check(
                name, scene, ivp, cfg, img)

        def frame_once():
            tile_trace.render_frame(scene, ivp, cfg)

        frame_once()
        res["frame_ms"] = _events_ms(frame_once, reps=5)
        _log(f"[{name} time] {card}: {res['frame_ms']:.4f} ms per {w}x{h} "
             f"frame, prologue included "
             f"({w * h / (res['frame_ms'] * 1e-3) / 1e6:.1f} Mrays/s)")
        out[name] = res
    return out


def _fused_rows_check(name, scene, ivp, cfg, img):
    """The fused launch of one frame against trace_fused_plain on the
    _check_rows tiles: counts equal, pixels within MAX_ABS_ERR. Returns
    (max |diff|, plain ms)."""
    from rtmm_tpu_torch.ops import tiled, tile_trace

    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx = pw // 32
    geo = dict(tiles_per_frame=tx * (ph // 32), tx=tx, pw=pw, ph=ph)
    rows = tile_trace.frame_inputs(scene, ivp, cfg,
                                   tile_trace.clusters_per_window(scene, cfg))
    meta, tables, opts = tile_trace.scene_tables(scene)
    args = (*rows, meta, tables, cfg)
    k_img, k_vis, k_elig = tile_trace.trace_fused(*args, **opts, **geo)
    check = _check_rows(rows[1], k_vis)
    (p_img, p_vis, p_elig), plain_ms = _timed(
        lambda: tile_trace.trace_fused_plain(*args, **opts, **geo,
                                             rows=check))
    _compare_counts(name, k_vis, p_vis, k_elig, p_elig, check)
    err = 0.0
    for t in check:
        y0, x0 = (t // tx) * 32, (t % tx) * 32
        err = max(err, float((k_img[0, y0:y0 + 32, x0:x0 + 32]
                              - p_img[0, y0:y0 + 32, x0:x0 + 32]).abs().max()))
    _log(f"[{name} check] fused launch vs plain on {len(check)} tiles (the "
         f"{TOP_TILES} with the most visits among them): visits "
         f"{int(k_vis[check].sum())} of {int(k_vis.sum())} equal per tile; "
         f"max |diff| {err:.3e}; plain {plain_ms:.1f} ms")
    if err > MAX_ABS_ERR or not torch.equal(
            k_img[0, :cfg.height, :cfg.width], img):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           "or with the main-path frame")
    return err, plain_ms


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
    _reset_all()
    img, stats = tile_trace.render_frame(baked, ivp, cfg, with_stats=True)
    torch.cuda.synchronize()
    _expect_launches("config 4 baked", {"tile_trace_fused": 1,
                                        **_prologue(1, 1)})
    nvis = int(stats["kernel_unit_visits"].sum())
    _log(f"[config 4] visits {nvis}, pin {EXPECTED_VISITS_4} (bench.py:265)")
    if abs(nvis - EXPECTED_VISITS_4) > VISITS_RTOL * EXPECTED_VISITS_4:
        raise RuntimeError(f"config 4 visits {nvis} outside 5% of the pin")
    _reset_all()
    two_level = inst_mod.render_instanced(base, ring, ivp, cfg)
    torch.cuda.synchronize()
    _expect_launches("config 4 two-level", {"tile_trace_raw": 1,
                                            **_prologue(1, 2)})
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

    _reset_all()
    img = renderer.render(ivp)
    u8 = renderer.render_u8(ivp)
    orbit = [renderer.render(m) for m in ivps]
    torch.cuda.synchronize()
    launches = _expect_launches(
        f"{name} main path", {"tile_trace_raw": 2 + ORBIT_8,
                              "tile_frusta": 2 + ORBIT_8,
                              "cluster_select": 2 * (2 + ORBIT_8)}
    )["tile_trace_raw"]
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
    if n_inst == 64:
        _prologue_instanced_cases(card, name, base, ring, ivp, cfg)
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
    _reset_all()
    img = inst_mod.render_instanced(base_c, ring, ivp, cfg)
    torch.cuda.synchronize()
    launches = _expect_launches(
        "config 8 compressed main path",
        {"tile_trace_raw_compressed": 1, **_prologue(1, 2)}
    )["tile_trace_raw_compressed"]
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
    _reset_all()
    capped, ms = _timed(lambda: inst_mod.render_instanced(base, ring, ivpv,
                                                          cfg1))
    got = _expect_launches("forced overflow", {
        "tile_trace_raw": 1, "tile_trace_windowed": None, "tile_frusta": 1,
        "cluster_select": None})
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
    from rtmm_tpu_torch.utils import spans
    spans.reset_launches()


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
    through PathTracer.render, launches held to one raw launch per frame,
    one K2 launch per window iteration, one pt_primary and PT_BOUNCES
    pt_bounce launches per frame. Returns the (image, stats) pairs and the
    launches by kernel."""
    _reset_all()
    rec = {}
    with _k2_recording(rec, launches=False):
        out = [tracer.render(m) for m in ivps]
    torch.cuda.synchronize()
    raw, k2 = kernels
    got = _expect_launches(f"{name} main path",
                           {raw: len(ivps), k2: rec["windows"],
                            "pt_primary": len(ivps),
                            "pt_bounce": len(ivps) * PT_BOUNCES,
                            "tile_frusta": len(ivps),
                            "cluster_select": 2 * len(ivps)})
    for img, st in out:
        live = st["live_rays_per_bounce"]
        if not (bool(torch.isfinite(img).all())
                and tuple(img.shape) == (PT_SIZE, PT_SIZE, 3)
                and bool((live[1:] <= live[:-1]).all()) and live[0] > 0):
            raise RuntimeError(f"{name}: frame malformed or live counts "
                               f"not monotone: {live.tolist()}")
    _log(f"[{name} main path] {len(ivps)} frames: {got[raw]} raw launches, "
         f"{got[k2]} K2 launches = {rec['windows']} window iterations over "
         f"{len(rec['traces'])} bounce traces, {got['pt_primary']} "
         f"pt_primary and {got['pt_bounce']} pt_bounce launches (1 and "
         f"{PT_BOUNCES} per frame, where PR 13's pt_spawn + pt_shade took "
         f"{2 * PT_BOUNCES + 1}); frames finite, live counts monotone")
    return out, got


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


@contextlib.contextmanager
def _pt_recording(rec: dict):
    """While active: record each path_shade.primary / bounce call of the
    path tracer (rec["primary"], rec["bounce"]: lists of (args,
    kwargs))."""
    from rtmm_tpu_torch.ops import path_shade
    orig = path_shade.primary, path_shade.bounce

    def primary(*args, **kwargs):
        rec.setdefault("primary", []).append((args, kwargs))
        return orig[0](*args, **kwargs)

    def bounce(*args, **kwargs):
        rec.setdefault("bounce", []).append((args, kwargs))
        return orig[1](*args, **kwargs)

    path_shade.primary, path_shade.bounce = primary, bounce
    try:
        yield rec
    finally:
        path_shade.primary, path_shade.bounce = orig


@contextlib.contextmanager
def _pt_plain():
    """While active, the path tracer's bounce work runs the plain versions
    on the card's tensors: the frame as it was before the kernels."""
    from rtmm_tpu_torch.ops import path_shade
    orig = path_shade.primary, path_shade.bounce
    path_shade.primary, path_shade.bounce = (path_shade.primary_plain,
                                             path_shade.bounce_plain)
    try:
        yield
    finally:
        path_shade.primary, path_shade.bounce = orig


def _pt_bound(kind: str, args, kwargs) -> tuple[float, str, str]:
    """Least time of one pt_primary / pt_bounce launch on these inputs:
    its bytes (each input read once, each output written once) over the
    HBM rate, or its operations over their peak rates (32-bit integer and
    float32 units work side by side, so the larger of the two), whichever
    is larger. Only the bytes an output depends on count: a bounce's idx
    on the drawn lanes; the last bounce's normal and direction on its
    hits. Returns (ms, "bytes" or "operations", how it was counted)."""
    from rtmm_tpu_torch.ops import path_shade
    if kind == "primary":
        total, spp, hit = args[1], args[2], args[7]
        pixels, hits = hit.shape[0], int(hit.sum())
        lanes, draws = spp * total, hits * spp
        # bn, d, o, t, hit in and the radiance out per pixel; o, d and
        # alive out per lane.
        nbytes = pixels * (41 + 12) + lanes * 25
        fp_ops = (pixels * PT_PIXEL_FP + hits * PT_DIRECT_FP_OPS
                  + draws * PT_DIR_FP_OPS + lanes * PT_LANE0_FP)
        what = (f"{pixels} pixels x {PT_PIXEL_FP} + {hits} hits x "
                f"{PT_DIRECT_FP_OPS} + {draws} draws x ({PT_DRAW_INT_OPS} "
                f"int32 + {PT_DIR_FP_OPS}) + {lanes} lanes x {PT_LANE0_FP} "
                "fp32")
    else:
        t, alive = args[6], args[7]
        spawn = kwargs.get("spawn", True)
        given = kwargs.get("hit")
        hit = (alive & (t < path_shade.BIG) & (t > 0.0) if given is None
               else alive & given)
        lanes, hits = alive.shape[0], int(hit.sum())
        draws = hits if spawn else 0
        # alive, t, rad in, rad and hit out per lane (a given hit mask
        # too); with spawn bn, d, o in and o, d out per lane, idx per draw;
        # without, bn and d on the hits.
        nbytes = lanes * (30 + (given is not None))
        nbytes += lanes * 60 + draws * 4 if spawn else hits * 24
        fp_ops = (lanes * PT_BOUNCE_FP_LANE + hits * PT_DIRECT_FP_OPS
                  + (lanes * PT_SPAWN_FP_LANE + draws * PT_DIR_FP_OPS
                     if spawn else hits * PT_NORMAL_FP))
        what = (f"{lanes} lanes x {PT_BOUNCE_FP_LANE}"
                + (f" + {lanes} x {PT_SPAWN_FP_LANE}" if spawn else
                   f" + {hits} normals x {PT_NORMAL_FP}")
                + f" + {hits} hits x {PT_DIRECT_FP_OPS} + {draws} draws x "
                f"({PT_DRAW_INT_OPS} int32 + {PT_DIR_FP_OPS}) fp32")
    int_ops = draws * PT_DRAW_INT_OPS
    ops_ms = max(int_ops / PEAK_INT32, fp_ops / PEAK_FP32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return (max(ops_ms, bytes_ms), by,
            f"{what} = {ops_ms:.6f} ms; {nbytes / 1e6:.3f} MB = "
            f"{bytes_ms:.6f} ms")


def _pt_draw_check(card, total: int, lanes: int, dev) -> dict:
    """The bounce kernels' uniforms on every lane against the plain draw
    on the card, bit for bit, for two seeds: pt_primary's (bounce 0, all
    spp x total lanes drawn) and pt_bounce's for bounces 1 and 2 (every
    lane of an unsorted state, idx = g)."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.ops import path_shade
    from rtmm_tpu_torch.utils import threefry
    sc = path_shade.shading_consts(RenderConfig())
    z3 = torch.zeros((total, 3), device=dev)
    z1 = torch.zeros(total, device=dev)
    nohit = torch.zeros(total, dtype=torch.bool, device=dev)
    g = torch.arange(lanes, dtype=torch.int32, device=dev)
    zl3 = torch.zeros((lanes, 3), device=dev)
    zl1 = torch.zeros(lanes, device=dev)
    dead = torch.zeros(lanes, dtype=torch.bool, device=dev)
    bad = 0
    for seed in PT_DRAW_SEEDS:
        for bounce in range(3):
            if bounce == 0:
                u = path_shade.primary(seed, total, lanes // total, z3, z3,
                                       z3, z1, nohit, sc, with_u=True)[4]
            else:
                u = path_shade.bounce(seed, bounce, total, zl3, zl3, zl3,
                                      zl1, dead, zl3, g, sc,
                                      with_u=True)[4]
            p = path_shade.rand2(threefry.key(seed, dev), bounce, g, total)
            bad += int((u.view(torch.int32) != p.view(torch.int32)).sum())
    _log(f"[pt draw] {card}: the uniforms of all {lanes} lanes (total "
         f"{total}) for bounce 0 (pt_primary) and bounces 1-2 (pt_bounce) "
         f"and seeds {PT_DRAW_SEEDS} against the plain draw (int64 "
         f"threefry) on the card: {bad} words differ")
    if bad:
        raise RuntimeError("the bounce kernels' draw differs from "
                           "jax.random's")
    return {"lanes": lanes, "seeds": list(PT_DRAW_SEEDS), "bounces": 3,
            "words_differ": bad}


def _ulp1_diff(a, b) -> float:
    """max |a - b| in ulp of 1."""
    return float((a - b).abs().max()) / float(np.finfo(np.float32).eps)


def _pt_checks(card, name, rec) -> dict:
    """pt_primary and pt_bounce against their plain versions on every
    call of one recorded frame: uniforms, origins, radiance, hit and
    alive bit for bit, directions bit for bit or within 2 ulp of 1 (cos /
    sin); each launch's device time (launches queued behind a spin)
    beside an empty kernel's on the same grid (the floor), PR 13's two
    kernels' ms for the same form, its wrapper's time per call (host work
    included), its plain version's and its bound."""
    from rtmm_tpu_torch.ops import path_shade
    res = {}
    for kind in ("primary", "bounce"):
        rows = []
        wrapper = getattr(path_shade, kind)
        plain = getattr(path_shade, f"{kind}_plain")
        for call, (args, kwargs) in enumerate(rec[kind]):
            spawn = kind == "primary" or kwargs.get("spawn", True)
            form = "primary" if kind == "primary" else f"bounce {args[1]}"
            k = wrapper(*args, **kwargs)
            nd = 2 if kind == "primary" else 3      # the directions
            if spawn:
                ku = wrapper(*args, **kwargs, with_u=True)
                p = plain(*args, **kwargs, with_u=True)
                exact = (all(torch.equal(a, b) for j, (a, b) in
                             enumerate(zip(ku[:-1], p[:-1])) if j != nd)
                         and all(torch.equal(a, b)
                                 for a, b in zip(k, ku[:-1]))
                         and torch.equal(ku[-1].view(torch.int32),
                                         p[-1].view(torch.int32)))
                ndiff = int((k[nd] != p[nd]).any(-1).sum())
                err = _ulp1_diff(k[nd], p[nd]) if k[nd].numel() else 0.0
                detail = (f"uniforms, origins, radiance and masks bit-equal "
                          f"{exact}; directions differ on {ndiff} lanes, "
                          f"max {err:.1f} ulp of 1")
            else:
                p = plain(*args, **kwargs)
                exact = all(torch.equal(a, b) for a, b in zip(k, p))
                err = 0.0 if exact else _ulp1_diff(k[0], p[0])
                detail = f"radiance and hit bit-equal {exact} (last bounce)"
            ok = exact and err <= 2.0
            lanes = k[1].shape[0] if kind == "primary" else k[0].shape[0]

            def kernel_once(args=args, kwargs=kwargs):
                wrapper(*args, **kwargs)

            def plain_once(args=args, kwargs=kwargs):
                plain(*args, **kwargs)

            blocks = -(-(args[1] if kind == "primary" else lanes) // 256)
            dev = k[0].device
            torch.cuda.synchronize()
            ms = _queued_ms(kernel_once)
            floor_ms = _queued_ms(
                lambda: path_shade.empty_launch(dev, blocks))
            wrapper_ms = _events_ms(kernel_once, reps=20)
            plain_ms = _events_ms(plain_once, reps=3)
            bound, by, how = _pt_bound(kind, args, kwargs)
            before = PT_MS_BEFORE.get(form)
            _log(f"[{name} pt_{kind} {call} ({form})] {card}: {lanes} lanes, "
                 f"{detail}; kernel {ms:.6f} ms on the device (20 launches "
                 f"queued behind a spin), an empty kernel on its {blocks} "
                 f"blocks {floor_ms:.6f} ms, wrapper {wrapper_ms:.4f} ms per "
                 f"call (20 calls back to back), plain {plain_ms:.4f} ms; "
                 f"bound {bound:.6f} ms ({by}: {how}), kernel at "
                 f"{bound / ms:.3f} of it")
            if before is not None:
                _log(f"[{name} pt_{kind} {call} ({form}) vs PR 13] "
                     f"{ms:.6f} ms against {before:.6f} ms of pt_shade + "
                     f"pt_spawn (PR 13 run 4, PT_MS_BEFORE)")
            if not ok:
                raise RuntimeError(f"{name}: pt_{kind} call {call} disagrees "
                                   "with its plain version")
            rows.append(dict(form=form, lanes=lanes, err_ulp=err, ms=ms,
                             floor_ms=floor_ms, wrapper_ms=wrapper_ms,
                             plain_ms=plain_ms, bound=(bound, by)))
        res[kind] = rows
    return res


def _pt_entry(kind: str, launches: int, checks: dict, **extra) -> dict:
    """The kernel-table entry of pt_primary / pt_bounce: the device ms,
    floor ms, wrapper ms, plain ms and bound of frame 0's primaries or
    first bounce (every launch's beside them), the launches of the main
    path, the largest difference in ulp of 1 (directions only: the rest
    is bit-equal)."""
    rows = checks[kind]
    first = next(r for r in rows if r["form"] in ("primary", "bounce 1"))
    entry = {"name": f"pt_{kind}", "route": "cuda",
             "source": "rtmm_tpu_torch/csrc/path_shade.cu",
             "replaces": ("rtmm_tpu/render/pathtrace.py:265-267 (shading), "
                          ":279 (bounce origin), :285-292 and :364-373 (pad, "
                          "draw, next ray), XLA-fused"
                          if kind == "primary" else
                          "rtmm_tpu/render/pathtrace.py:342-350 (rand2) and "
                          ":472-487 (hit, shading, next ray), XLA-fused"),
             "launches": launches,
             "max_abs_err": max(r["err_ulp"] for r in rows)
             * float(np.finfo(np.float32).eps),
             "ms": first["ms"], "floor_ms": first["floor_ms"],
             "wrapper_ms": first["wrapper_ms"],
             "plain_ms": first["plain_ms"], "bound_ms": first["bound"][0],
             "bound_by": first["bound"][1],
             "library_ms": None,
             "library": "none: torch.rand is Philox, not jax.random's "
                        "threefry",
             "per_launch": rows}
    entry.update(extra)
    return entry


def _pt_kernel_frame(card, name, tracer, ivp, img0, st0) -> dict:
    """The frame with pt_primary / pt_bounce against the same frame with
    their plain versions on the card (bit for bit, or within config 5's
    gate where cos / sin differ; live counts equal), the stage ms of
    both and the frame's kernel launch calls (torch.profiler's host
    events)."""
    with _pt_plain():
        img_p, st_p = tracer.render(ivp)
        torch.cuda.synchronize()
        stages_plain = _frame_stages(tracer, ivp)
    same = torch.equal(img_p, img0)
    gate = _pt_gate(img0, img_p)
    live_eq = torch.equal(st_p["live_rays_per_bounce"],
                          st0["live_rays_per_bounce"])
    stages = _frame_stages(tracer, ivp)
    before = stages_plain.get("shade+spawn", 0.0)
    after = stages.get("shade+spawn", 0.0)
    launch_calls = _profiled(lambda: tracer.render(ivp))["launch_calls"]
    _log(f"[{name} pt kernels vs plain frame] {card}: frame bit-equal "
         f"{same}; gate {gate}; live counts equal {live_eq}; shade+spawn "
         f"stage {before:.4f} ms plain -> {after:.4f} ms kernels; the "
         f"frame's kernel launch calls {launch_calls}; "
         "stages plain: " + "; ".join(f"{k} {v:.4f} ms"
                                      for k, v in stages_plain.items())
         + "; stages kernels: " + "; ".join(f"{k} {v:.4f} ms"
                                           for k, v in stages.items()))
    if not (gate["ok"] and live_eq):
        raise RuntimeError(f"{name}: the frame with pt_primary / pt_bounce "
                           f"differs from the plain one: {gate}")
    return dict(bit_equal=same, gate=gate, stages_plain_ms=stages_plain,
                stages_ms=stages, shade_spawn_plain_ms=before,
                shade_spawn_ms=after, launch_calls=launch_calls)


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
    out, got = _pt_frames(tracer, [ivp, ivp] + ivps, "config 5",
                          ("tile_trace_raw", "group_trace"))
    k2_launches = got["group_trace"]
    _prologue_frame_cases(card, "config 5 primary", scene, ivp, cfg)
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
    rec, prec = {}, {}
    with _k2_recording(rec, launches=True), _pt_recording(prec):
        img_r, _ = tracer.render(ivp)
    torch.cuda.synchronize()
    if not torch.equal(img_r, img0):
        raise RuntimeError("config 5: recorded frame differs")
    checks, k2_per_bounce = _k2_frame0(card, "config 5", rec["launches"],
                                       False)
    first = checks[0]

    # -- pt_primary / pt_bounce against their plain versions ----------------
    total = PT_SIZE * PT_SIZE
    draw = _pt_draw_check(card, total, PT_SPP * total, scene.device)
    pt_checks = _pt_checks(card, "config 5", prec)
    pt_frame = _pt_kernel_frame(card, "config 5", tracer, ivp, img0, st0)
    pt_entries = [_pt_entry(kind, got[f"pt_{kind}"], pt_checks,
                            launches_per_frame=(1 if kind == "primary"
                                                else PT_BOUNCES),
                            frame=pt_frame, draw=draw)
                  for kind in ("primary", "bounce")]

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
    return (entry, img0, scene.device_bytes(), mesh, cfg, pt, ivp,
            pt_entries)


def phase_config5_compressed(card, mesh, cfg, pt, ivp, img5, bytes5,
                             pt_entries):
    """Config 5 over a compressed scene (RTMM_PT_COMPRESSED=1,
    bench.py:152-156): K1d + K1c primaries, K2 compressed bounces,
    pt_primary / pt_bounce (their checks added to pt_entries)."""
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.render import pathtrace

    scene = scene_mod.build_device_scene(mesh, compressed=True,
                                         device="cuda")
    tracer = pathtrace.PathTracer(scene, cfg, pt)
    _log(f"[config 5 compressed] U = {scene.num_units} units, indexed "
         f"{scene.indexed}: {scene.device_bytes() / 2**20:.2f} MiB on the card "
         f"against {bytes5 / 2**20:.2f} MiB precomputed")
    out, got = _pt_frames(
        tracer, [ivp, ivp], "config 5 compressed",
        ("tile_trace_raw_compressed", "group_trace_compressed"))
    k2_launches = got["group_trace_compressed"]
    img, st = out[0]
    gate = _pt_gate(img, img5)
    _log(f"[config 5 compressed] frame vs the precomputed scene's: {gate}; "
         f"live {st['live_rays_per_bounce'].tolist()}")
    if not gate["ok"]:
        raise RuntimeError(f"config 5 compressed fails the gate: {gate}")
    rec, prec = {}, {}
    with _k2_recording(rec, launches=True), _pt_recording(prec):
        img_r, _ = tracer.render(ivp)
    torch.cuda.synchronize()
    if not torch.equal(img_r, img):
        raise RuntimeError("config 5 compressed: recorded frame differs")
    checks, k2_per_bounce = _k2_frame0(card, "config 5 compressed",
                                       rec["launches"], True)
    first = checks[0]
    pt_checks = _pt_checks(card, "config 5 compressed", prec)
    pt_frame = _pt_kernel_frame(card, "config 5 compressed", tracer, ivp,
                                img, st)
    for e in pt_entries:
        kind = e["name"][3:]
        e["config5_compressed"] = {
            "launches": got[e["name"]],
            "max_abs_err": max(r["err_ulp"] for r in pt_checks[kind])
            * float(np.finfo(np.float32).eps),
            "per_launch": pt_checks[kind], "frame": pt_frame}

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


def _save_config3(tmp: str) -> str:
    """Write bench config 3's asset (a 1,280-base-triangle subdiv-3
    icosphere, level 3) as .gltf + .bary under tmp; returns the .gltf."""
    from rtmm_tpu_torch.io import loader
    from rtmm_tpu_torch.models import procedural
    path = f"{tmp}/sphere3_l3.gltf"
    loader.save_gltf_bary(procedural.make_icosphere(
        subdivisions=3, level=3, amplitude=0.12), path)
    return path


def _png_frames(path: str, n: int, prefix: str) -> list:
    from rtmm_tpu_torch.io import image as image_io
    return [image_io.read_png(os.path.join(path, f"{prefix}_{i:04d}.png"))
            for i in range(n)]


def phase_perray(card, mesh, img_main, ivp, cfg):
    """Config 3 through the per-ray reference backend at 1080p."""
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.ops import raygen, shading, traversal
    from rtmm_tpu_torch.render.renderer import Renderer, _pick_chunk
    from rtmm_tpu_torch.utils import stats
    from rtmm_tpu_torch.utils.gate import image_gate

    t0 = time.perf_counter()
    scene = scene_mod.build_device_scene(mesh, hierarchy=True, device="cuda")
    scene_t = scene_mod.build_device_scene(mesh, tessellated=True,
                                           device="cuda")
    torch.cuda.synchronize()
    _log(f"[perray scene] config 3 with hierarchy tables: "
         f"{scene.device_bytes() / 2**20:.1f} MiB on the card; -T "
         f"{scene_t.device_bytes() / 2**20:.1f} MiB; build "
         f"{time.perf_counter() - t0:.1f} s")
    cfg_ray = dataclasses.replace(cfg, pipeline="ray")
    chunk = _pick_chunk(cfg_ray, scene)
    _reset_all()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ray = Renderer(scene, cfg_ray)
    frames = []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(2):
        frames.append(ray.render(ivp))
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop) / 2
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.equal(frames[1], frames[0]):
        raise RuntimeError("per-ray: two renders of one frame differ")
    img8 = frames[0]
    # The candidate cut: the base-triangle AABBs each ray enters.
    o, d = raygen.generate_rays(ivp, cfg.width, cfg.height,
                                device=scene.device)
    enters = {name: torch.cat([traversal.aabb_hit_counts(
        s, o[c:c + chunk], d[c:c + chunk]) for c in range(0, len(o), chunk)])
        for name, s in (("micromesh", scene), ("-T", scene_t))}
    k_all = max(int(e.max()) for e in enters.values())
    cfg_all = dataclasses.replace(cfg_ray, max_candidates=k_all)
    img, ms_all = _timed(lambda: Renderer(scene, cfg_all).render(ivp))
    img_t = Renderer(scene_t, cfg_all).render(ivp)
    # Launches of one chunk of the default frame (the same ops for every
    # chunk: no host branch inside one), and the device's share of them.
    mid = (len(o) // chunk // 2) * chunk
    oc, dc = o[mid:mid + chunk], d[mid:mid + chunk]
    traversal.trace(scene, oc, dc, cfg_ray)
    with tempfile.TemporaryDirectory() as logdir:
        with stats.profiler_trace(logdir):
            t, nrm, hit = traversal.trace(scene, oc, dc, cfg_ray)
            shading.shade_or_miss(hit, nrm, -dc, cfg_ray)
        busy = stats.device_busy(logdir)
    torch.cuda.synchronize()
    _expect_launches("per-ray frames", {})   # no kernel, prologue's neither
    n = cfg.width * cfg.height
    n_chunks = -(-n // chunk)
    # The default frame: exact wherever a ray enters at most
    # max_candidates AABBs, and every big pixel where one enters more.
    within = (enters["micromesh"] <= cfg.max_candidates).reshape(
        cfg.height, cfg.width)
    gate8_all = image_gate(img8, img_main)
    gate8 = image_gate(img8, img_main, mask=within)
    big8 = (img8 - img_main).abs().amax(dim=-1) > 0.25
    stray = int((big8 & within).sum())
    same = torch.equal(img8[within], img[within])
    gate = image_gate(img, img_main)
    rmse = float(torch.sqrt(((img - img_t) ** 2).mean()))
    over = int((~within).sum())
    _log(f"[perray] {card}: config 3 1080p through pipeline ray, "
         f"{cfg.max_candidates} candidates per ray: {ms:.4f} ms per frame "
         f"(CUDA events over 2 calls), {n / (ms * 1e-3) / 1e6:.4f} Mrays/s; "
         f"{n_chunks} chunks of {chunk} rays; peak memory "
         f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held "
         f"before")
    _log(f"[perray launches] {card}: one {chunk}-ray chunk (trace + shade) "
         f"under the profiler: {busy['kernels']} kernel events, so "
         f"{busy['kernels'] * n_chunks} per frame over {n_chunks} chunks; "
         f"device busy {busy['busy_us'] / 1e3:.4f} ms of a "
         f"{busy['window_us'] / 1e3:.4f} ms traced window: busy share "
         f"{busy['share']}")
    _log(f"[perray cut] {over} rays enter more than {cfg.max_candidates} "
         f"triangle AABBs (at most {k_all}); against phase 3's K1a frame: "
         f"all pixels {gate8_all}; the {n - over} pixels within the cut "
         f"{gate8}; big pixels within the cut: {stray}; equal there to the "
         f"{k_all}-candidate frame: {same}")
    _log(f"[perray exact] {card}: {k_all} candidates per ray (the most "
         f"AABBs a ray enters): {ms_all:.1f} ms (host clock); against phase "
         f"3's K1a frame: {gate}; -T per-ray frame against it: RMSE "
         f"{rmse:.3e} (limit 1e-3)")
    if not all(bool(torch.isfinite(x).all()) for x in (img8, img, img_t)):
        raise RuntimeError("per-ray frames are not finite")
    if not gate8["ok"] or stray or not same:
        raise RuntimeError(f"per-ray frame at {cfg.max_candidates} "
                           f"candidates: gate within the cut {gate8}, "
                           f"{stray} big pixels within it, equal to the "
                           f"exact frame there: {same}")
    if not gate["ok"]:
        raise RuntimeError(f"per-ray frame fails the gate: {gate}")
    if rmse > 1e-3:
        raise RuntimeError(f"per-ray micromesh vs -T: RMSE {rmse:.3e}")
    if not busy["kernels"] or busy["share"] is None:
        raise RuntimeError(f"the per-ray chunk's trace holds no CUDA kernel "
                           f"event: {busy}")
    return scene


def _stats_orbit_child() -> None:
    """Phase 17's profiled orbit, in a process of its own: config 3's
    scene with its hierarchy tables, one warm-up orbit, then one 32-frame
    orbit (render_frames) under torch.profiler, counted. Prints its
    device_busy and launches as one JSON line. A stopgap: on the H100
    machines this runs on, a trace's device events come back offset
    from their launch calls by milliseconds, or not at all, more often
    the longer the profiled process has run and whatever kernels ran
    (tools/profiler_probe.py); late in this script's own process an
    orbit of three launches traced none, while a fresh process's first
    session has held them."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.io import loader
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.utils import spans

    with tempfile.TemporaryDirectory() as tmp:
        mesh = loader.load_micromesh(_save_config3(tmp))
    scene = scene_mod.build_device_scene(mesh, hierarchy=True,
                                         device="cuda")
    cfg = RenderConfig(width=WIDTH, height=HEIGHT)
    ivps = np.stack([_camera(25.0 + 360.0 / ORBIT_FRAMES * k, cfg)
                     for k in range(ORBIT_FRAMES)])
    tile_trace.render_frames(scene, ivps, cfg)
    torch.cuda.synchronize()
    _reset_all()
    busy = _profiled(lambda: tile_trace.render_frames(scene, ivps, cfg))
    launches = {k: n for k, n in spans.launches().items() if n}
    print(json.dumps({"busy": busy, "launches": launches}))


def phase_stats(card, scene, ivp, ivps, cfg):
    """The stats path at 1080p: heatmap, FrameStats, the kernel's visits,
    counted, and a profiler trace of one orbit in a process of its own
    (_stats_orbit_child), counted there."""
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.utils import stats

    _reset_all()
    t0 = time.perf_counter()
    hm = stats.traversal_heatmap(scene, ivp, cfg)
    hm_s = time.perf_counter() - t0
    fs = stats.collect_frame_stats(scene, ivp, cfg)
    _img, kst = tile_trace.render_frame(scene, ivp, cfg, with_stats=True)
    visits = int(kst["kernel_unit_visits"].sum())
    eligible = int(kst["kernel_unit_eligible"].sum())
    torch.cuda.synchronize()
    _expect_launches("stats path", {"tile_trace_fused": 3,
                                    **_prologue(3, 3)})
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke._stats_orbit_child()"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the profiled orbit's process failed (rc "
                           f"{proc.returncode}): {proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    busy = child["busy"]
    _log(f"[stats profiler launches] {child['launches']}")
    if child["launches"] != {"tile_trace_fused": 1, "tile_frusta": 1,
                             "cluster_select": 1}:
        raise RuntimeError(f"the profiled orbit launched "
                           f"{child['launches']}")
    _log(f"[stats] heatmap {hm.shape} in {hm_s:.1f} s: {int(hm.sum())} "
         f"steps, max {int(hm.max())} per ray, "
         f"{int((hm > 0).sum())} pixels with work; FrameStats "
         f"{fs.as_dict()}; kernel visits {visits} of {eligible} eligible "
         f"(pin {EXPECTED_VISITS}, bench.py:264)")
    _log(f"[stats profiler] {card}: one {ORBIT_FRAMES}-frame orbit "
         f"(render_frames): {busy['kernels']} kernel events of "
         f"{busy['launch_calls']} launch calls, device busy "
         f"{busy['busy_us'] / 1e3:.4f} ms of a {busy['window_us'] / 1e3:.4f} "
         f"ms traced window: busy share {busy['share']}")
    if hm.shape != (cfg.height, cfg.width) or not hm.max() > 0:
        raise RuntimeError(f"heatmap malformed: {hm.shape}")
    if fs.traversal_steps_total != int(hm.sum()):
        raise RuntimeError(f"traversal_steps_total {fs.traversal_steps_total}"
                           f" != heatmap sum {int(hm.sum())}")
    if visits != EXPECTED_VISITS:
        raise RuntimeError(f"--stats kernel visits {visits} != "
                           f"{EXPECTED_VISITS}")
    if not busy["kernels"] or busy["share"] is None:
        raise RuntimeError(f"the profiler trace holds no CUDA kernel event: "
                           f"{busy}")


def phase_perray_engine(card, mesh5):
    """Config 5's scene with its hierarchy: the perray engine against the
    pallas engine at the 256x256 gate frame."""
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.render import pathtrace

    scene = scene_mod.build_device_scene(mesh5, hierarchy=True,
                                         device="cuda")
    cfg = RenderConfig(width=PT_VERIFY, height=PT_VERIFY, sub_frusta=8)
    ivp = _camera(25.0, cfg)
    pt = pathtrace.PathTraceConfig(bounces=PT_BOUNCES,
                                   samples_per_pixel=PT_SPP, engine="perray")
    perray = pathtrace.PathTracer(scene, cfg, pt)
    _reset_all()
    (a, sa), ms = _timed(lambda: perray.render(ivp))
    _expect_launches("perray engine", {"pt_primary": 1,
                                       "pt_bounce": PT_BOUNCES})
    b, sb = pathtrace.PathTracer(scene, cfg, dataclasses.replace(
        pt, engine="pallas")).render(ivp)
    torch.cuda.synchronize()
    _expect_launches("pallas engine", {"tile_trace_raw": 1,
                                       "group_trace": None,
                                       "pt_primary": 2,
                                       "pt_bounce": 2 * PT_BOUNCES,
                                       **_prologue(1, 2)})
    gate = _pt_gate(a, b)
    dlive = float((sa["live_rays_per_bounce"]
                   - sb["live_rays_per_bounce"]).abs().max())
    (_, _), ms2 = _timed(lambda: perray.render(ivp))
    _log(f"[perray engine] {card}: config 5 at {PT_VERIFY}x{PT_VERIFY}, "
         f"{PT_BOUNCES} bounces, {PT_SPP} spp, {pt.ray_chunk}-ray chunks: "
         f"frame {ms:.4f} / {ms2:.4f} ms (host clock, synchronized); "
         f"against the pallas engine: {gate}; live "
         f"{sa['live_rays_per_bounce'].tolist()} vs "
         f"{sb['live_rays_per_bounce'].tolist()} (max |diff| {dlive}); "
         f"overflow {sa['overflow_groups_per_bounce'].tolist()}")
    if not gate["ok"] or dlive > 4:
        raise RuntimeError(f"perray vs pallas engine: {gate}, {dlive}")


def phase_debug_cache(card, scene, img_main, ivp, cfg):
    """The debug render, the scene cache and the viewer's headless orbit
    on config 3 at 1080p."""
    from rtmm_tpu_torch.io import loader
    from rtmm_tpu_torch.ops import tile_trace
    from rtmm_tpu_torch.render.renderer import Renderer
    from rtmm_tpu_torch.utils import cache
    from rtmm_tpu_torch.utils.debug import debug_render
    from rtmm_tpu_torch.utils.gate import image_gate
    from rtmm_tpu_torch.viewer import Viewer

    _reset_all()
    img, ms = _timed(lambda: debug_render(scene, ivp, cfg))
    lv = scene.leaf_verts.clone()
    lv.reshape(-1)[int(torch.nonzero(lv.reshape(-1))[12345])] = float("nan")
    try:
        debug_render(dataclasses.replace(scene, leaf_verts=lv), ivp, cfg)
    except FloatingPointError as exc:
        caught = str(exc)
    else:
        raise RuntimeError("debug_render missed a NaN in leaf_verts")
    _expect_launches("debug render", {})   # no kernel, prologue's neither
    gate = image_gate(img, img_main)
    _log(f"[debug] clean config 3 at 1080p passes in {ms:.1f} ms (host "
         f"clock; tile backend with guards), against phase 3's K1a frame: "
         f"{gate}; NaN in leaf_verts: FloatingPointError '{caught}'")
    if not gate["ok"]:
        raise RuntimeError(f"debug render fails the gate: {gate}")
    with tempfile.TemporaryDirectory() as tmp:
        path = _save_config3(tmp)
        cdir = f"{tmp}/cache"
        reads = []
        load = loader.load_micromesh
        loader.load_micromesh = lambda p: reads.append(p) or load(p)
        try:
            s1, ms1 = _timed(lambda: cache.build_device_scene_cached(
                path, cache_dir=cdir))
            s2, ms2 = _timed(lambda: cache.build_device_scene_cached(
                path, cache_dir=cdir))
        finally:
            loader.load_micromesh = load
        files = os.listdir(cdir)
        same = all(
            torch.equal(getattr(s1, f.name), getattr(s2, f.name))
            if isinstance(getattr(s1, f.name), torch.Tensor)
            else getattr(s1, f.name) == getattr(s2, f.name)
            for f in dataclasses.fields(s1))
        _reset_all()
        img_c = tile_trace.render_frame(s2, ivp, cfg)
        Viewer(Renderer(s2, cfg))._run_orbit(2, f"{tmp}/view")
        torch.cuda.synchronize()
        _expect_launches("cache and viewer", {"tile_trace_fused": 3,
                                              **_prologue(3, 3)})
        views = _png_frames(f"{tmp}/view", 2, "view")
    _log(f"[cache] build {ms1:.1f} ms (asset reads {len(reads)}), then "
         f"{ms2:.1f} ms from {files}; tables bit-equal: {same}; K1a frame "
         f"of the loaded scene bit-equal to phase 3's: "
         f"{torch.equal(img_c, img_main)}; viewer orbit frames "
         f"{[v.shape for v in views]}")
    if len(reads) != 1 or len(files) != 1 or not same:
        raise RuntimeError(f"cache: reads {reads}, files {files}, "
                           f"equal {same}")
    if not torch.equal(img_c, img_main):
        raise RuntimeError("cache: the loaded scene renders another frame")
    if any(v.shape != (cfg.height, cfg.width, 3) for v in views) or \
            np.array_equal(views[0], views[1]):
        raise RuntimeError("viewer: orbit frames malformed")



# Phase 20: the multi-device path (parallel/sharding.py) on the one card.
# Ranks are spawned processes: a world of one over NCCL, worlds of two and
# four over gloo with the ranks sharing the card (NCCL refuses two ranks
# on one device), so their times measure overhead, not scaling. Config 3
# walks in windows of CLUSTERS_PER_WINDOW_3 clusters, as phase 7(a), so
# that each scene shard's walk spans several windows; config 9 takes one
# window per shard. MD_REPS frames are timed after each counted one.
MD_REPS = 5
MD_TIMEOUT_S = 600
# The per-ray layout: config 3 at 480x270 with as many candidates per ray
# as the most triangle AABBs a ray of the 1080p frame enters (23, phase
# 16): no candidate cut on the single card or on either shard.
RAY_W, RAY_H, RAY_CANDIDATES = 480, 270, 23


def _md_job(shape, scene, cfg, ivp, pipeline="tile", backend="pallas",
            reps=MD_REPS, device="cuda"):
    return dict(shape=shape, device=device, scene=scene, cfg=cfg, ivp=ivp,
                pipeline=pipeline, backend=backend, reps=reps)


def _md_spawn(world, scenes, jobs):
    """Run jobs on a world of ranks; returns, per job, the ranks'
    results."""
    from rtmm_tpu_torch.parallel import entry, launch
    t0 = time.perf_counter()
    out = launch.spawn(entry.render_jobs, world, jobs[0]["device"],
                       args=(scenes, jobs), timeout_s=MD_TIMEOUT_S)
    _log(f"[multi-device] {world} rank(s) over {out[0][0]['backend']}: "
         f"{len(jobs)} layout(s) in {time.perf_counter() - t0:.1f} s, rank "
         "start-up included")
    return [[r[i] for r in out] for i in range(len(jobs))]


def _md_single(scene, cfg, ivp):
    """The single-card windowed trace at the shards' kc rule: ((t, summed
    normals (tiles, TILE, 3), visits) as NumPy, its frame, and the
    frame's ms (CUDA events))."""
    from rtmm_tpu_torch.ops import tile_trace
    ivp_t = torch.as_tensor(ivp, dtype=torch.float32, device=scene.device)
    kc = tile_trace.clusters_per_window(scene, cfg)
    fi, frus, raymat = tile_trace.ray_frame_inputs(scene, ivp_t, cfg)
    t0, n0, vis0, _, _ = tile_trace.trace_windows(scene, fi, frus, raymat,
                                                  cfg, kc)
    img0 = tile_trace.render_windowed(scene, ivp_t, cfg, kc)[0]
    ms = _events_ms(lambda: tile_trace.render_windowed(scene, ivp_t, cfg,
                                                       kc), reps=1, rounds=3)
    return ((t0.cpu().numpy(), n0.transpose(1, 2).cpu().numpy(),
             vis0.cpu().numpy()), img0, ms)


def _md_layout(card, name, results, backend, chosen, single_ms,
               kernel=None, every_rank=True):
    """Check every rank ran over `backend`, chose `chosen` and returned
    the same frame, and that `kernel` launched once per window of each rank's walk (on every
    rank, unless every_rank is False: a rank whose tiles hit no cluster
    walks no window), beside one tile_frusta and 1 + windows
    cluster_select per rank; with no `kernel`, that no kernel launched,
    the prologue's neither. Log the layout's times, launches and per-rank
    scene MiB. Returns its record for the kernel table."""
    for r in results:
        if (r["backend"], r["chosen"]) != (backend, chosen):
            raise RuntimeError(f"{name}: rank {r['rank']} ran over "
                               f"{r['backend']} and chose {r['chosen']}, "
                               f"not {backend} and {chosen}")
        if not np.array_equal(r["image"], results[0]["image"]):
            raise RuntimeError(f"{name}: the ranks returned different "
                               "frames")
    launches = [r["launches"].get(kernel, 0) for r in results]
    windows = [r["trace"]["windows"] for r in results
               if kernel is not None]
    if kernel is not None and (
            (every_rank and min(launches) == 0) or not max(launches)
            or (windows and windows != launches)):
        raise RuntimeError(f"{name}: {kernel} launches per rank "
                           f"{launches}, windows {windows}")
    # Each rank's prologue: one tile_frusta for its tile range, one
    # cluster_select for its cull and one per window.
    prologue = [(r["launches"].get("tile_frusta", 0),
                 r["launches"].get("cluster_select", 0)) for r in results]
    if kernel is not None and prologue != [(1, 1 + n) for n in launches]:
        raise RuntimeError(f"{name}: (tile_frusta, cluster_select) "
                           f"launches per rank {prologue}, {kernel} "
                           f"{launches}")
    if kernel is None and any(r["launches"] for r in results):
        raise RuntimeError(f"{name}: trace kernels launched: "
                           f"{[r['launches'] for r in results]}")
    ms = [r["ms_events"] for r in results]
    shares = len(results) > torch.cuda.device_count()
    shared = " (ranks share one card)" if shares else ""
    _log(f"[{name} time] {card}: {backend}{shared}: ms per frame, CUDA "
         f"events per rank {[round(m, 4) for m in ms]}, host clock on rank "
         f"0 {results[0]['ms_wall']:.4f}; single card {single_ms:.4f}; "
         + (f"{kernel} launches per rank {launches}, (tile_frusta, "
            f"cluster_select) {prologue}; " if kernel else "")
         + "scene MiB per rank "
         f"{[round(r['shard_bytes'] / 2**20, 2) for r in results]}")
    return {"backend": backend, "ranks_share_one_card": shares,
            "launches": launches, "ms": ms, "ms_wall": results[0]["ms_wall"]}


def _md_rows_equal(name, results, ref):
    """Rays-only layouts: each rank's rows bit-equal to the single-card
    windowed trace (t, summed normals, visits); the visits sum to its."""
    t0, n0, vis0 = ref
    gathered = np.zeros_like(vis0)      # overlap tiles counted once
    for r in results:
        tr = r["trace"]
        rows = slice(tr["tile0"], tr["tile0"] + tr["t"].shape[0])
        for key, want in (("t", t0), ("n", n0), ("visits", vis0)):
            if not np.array_equal(tr[key], want[rows]):
                raise RuntimeError(f"{name}: rank {r['rank']}'s {key} "
                                   "differs from the single-card trace")
        gathered[rows] = tr["visits"]
    total = int(gathered.sum())
    _log(f"[{name} check] t, normals and visits of every rank's tiles "
         f"bit-equal to the single-card windowed trace; visits {total} = "
         f"{int(vis0.sum())}")
    if total != int(vis0.sum()):
        raise RuntimeError(f"{name}: visits {total} != {int(vis0.sum())}")


def _md_combined(name, results, ref, img0):
    """Scene layouts: rays whose combined t or normal differs from the
    single card's (printed), the frame within the two-tier gate."""
    from rtmm_tpu_torch.utils.gate import image_gate
    t0, n0, vis0 = ref
    t_diff = n_diff = 0
    for r in results:
        if r["scene_index"]:
            continue
        tr = r["trace"]
        rows = slice(tr["tile0"], tr["tile0"] + tr["t"].shape[0])
        t_diff += int((tr["t"] != t0[rows]).sum())
        n_diff += int((tr["n"] != n0[rows]).any(-1).sum())
    shard_vis = [int(r["trace"]["visits"].sum()) for r in results]
    gate = image_gate(torch.from_numpy(results[0]["image"]), img0.cpu())
    _log(f"[{name} check] rays whose combined t differs from the single "
         f"card's: {t_diff}; whose summed normal differs: {n_diff}; visits "
         f"per rank {shard_vis}, single card {int(vis0.sum())}; frame "
         f"against the single card's: {gate}")
    if not gate["ok"]:
        raise RuntimeError(f"{name}: frame fails the gate: {gate}")


def phase_multidevice(card, scene, ivp, cfg, scene9, arrays_h, kernels):
    """Phase 20: config 3 (and config 9 compressed) through the sharded
    renderer on 1x1 (NCCL), 2x1, 1x2, 2x2 (gloo), the gspmd and per-ray
    pipelines, and dryrun_multichip(4)."""
    from rtmm_tpu_torch.models import scene as scene_mod
    from rtmm_tpu_torch.ops import tiled
    from rtmm_tpu_torch.parallel import entry
    from rtmm_tpu_torch.render.renderer import render_ray
    from rtmm_tpu_torch.utils.gate import image_gate

    t_phase = time.perf_counter()
    dev = scene.device
    job = functools.partial(_md_job, device=dev.type)
    cfg3 = dataclasses.replace(
        cfg, kernel_clusters_per_window=CLUSTERS_PER_WINDOW_3)
    ivp_t = torch.as_tensor(ivp, dtype=torch.float32, device=dev)

    ref3, img3, ms3 = _md_single(scene, cfg3, ivp)
    ref9, img9, ms9 = _md_single(scene9, cfg, ivp)
    mib3 = scene.device_bytes() / 2**20
    mib9 = scene9.device_bytes() / 2**20
    cfg_ray = dataclasses.replace(cfg, width=RAY_W, height=RAY_H,
                                  pipeline="ray",
                                  max_candidates=RAY_CANDIDATES)
    ivp_ray = _camera(25.0, cfg_ray)
    scene_h = scene_mod.scene_from_arrays(arrays_h, device=dev)
    img_ray = render_ray(scene_h, ivp_ray, cfg_ray)
    ms_ray = _events_ms(lambda: render_ray(scene_h, ivp_ray, cfg_ray),
                        reps=1, rounds=1)
    mib_h = scene_h.device_bytes() / 2**20
    del scene_h
    img_tiled = tiled.render_tiled(scene, ivp_t, cfg)
    ms_tiled = _events_ms(lambda: tiled.render_tiled(scene, ivp_t, cfg),
                          reps=1, rounds=1)
    _log(f"[multi-device single card] {card}: config 3 windowed (kc "
         f"{CLUSTERS_PER_WINDOW_3}) {ms3:.4f} ms per frame, {mib3:.1f} MiB; "
         f"config 9 windowed {ms9:.4f} ms, {mib9:.1f} MiB; XLA tile "
         f"backend {ms_tiled:.4f} ms; per-ray {RAY_W}x{RAY_H} with "
         f"{RAY_CANDIDATES} candidates {ms_ray:.4f} ms, {mib_h:.1f} MiB")
    scenes = {"c3": scene_mod.scene_arrays(scene),
              "c9": scene_mod.scene_arrays(scene9), "c3h": arrays_h}
    k1b, k1bc = "tile_trace_windowed", "tile_trace_windowed_compressed"
    sharded, sharded_c = {}, {}

    # (a) 1x1 over NCCL.
    (one,) = _md_spawn(1, scenes, [
        job((1, 1), "c3", cfg3, ivp)])
    sharded["1x1"] = _md_layout(card, "multi-device 1x1", one, "nccl",
                                ("tile-sharded", "pallas"), ms3, k1b)
    _md_rows_equal("multi-device 1x1", one, ref3)

    # (b) 2x1, (c) 1x2, (d) config 9 compressed on 1x2, (e) gspmd on 2x1,
    # (f) per-ray on 1x2: one world of two ranks sharing the card.
    r21, r12, r12c, rg, rray = _md_spawn(2, scenes, [
        job((2, 1), "c3", cfg3, ivp),
        job((1, 2), "c3", cfg3, ivp),
        job((1, 2), "c9", cfg, ivp),
        job((2, 1), "c3", cfg, ivp, backend="auto", reps=1),
        job((1, 2), "c3h", cfg_ray, ivp_ray, pipeline="ray", reps=1)])
    sharded["2x1"] = _md_layout(card, "multi-device 2x1", r21, "gloo",
                                ("tile-sharded", "pallas"), ms3, k1b)
    _md_rows_equal("multi-device 2x1", r21, ref3)
    sharded["1x2"] = _md_layout(card, "multi-device 1x2", r12, "gloo",
                                ("tile-sharded", "pallas"), ms3, k1b)
    _md_combined("multi-device 1x2", r12, ref3, img3)
    sharded_c["config 9 1x2"] = _md_layout(
        card, "multi-device config 9 1x2", r12c, "gloo",
        ("tile-sharded", "pallas"), ms9, k1bc)
    _md_combined("multi-device config 9 1x2", r12c, ref9, img9)
    _md_layout(card, "multi-device gspmd 2x1", rg, "gloo",
               ("tile-gspmd", None), ms_tiled)
    gate = image_gate(torch.from_numpy(rg[0]["image"]), img_tiled.cpu())
    _log(f"[multi-device gspmd 2x1 check] against the single card's XLA "
         f"tile frame: {gate}")
    if not gate["ok"]:
        raise RuntimeError(f"gspmd 2x1 fails the gate: {gate}")
    _md_layout(card, "multi-device per-ray 1x2", rray, "gloo",
               ("ray", None), ms_ray)
    gate = image_gate(torch.from_numpy(rray[0]["image"]), img_ray.cpu())
    _log(f"[multi-device per-ray 1x2 check] {RAY_W}x{RAY_H}, "
         f"{RAY_CANDIDATES} candidates, against the single card's per-ray "
         f"frame: {gate}")
    if not gate["ok"]:
        raise RuntimeError(f"per-ray 1x2 fails the gate: {gate}")

    # (c) 2x2: four ranks sharing the card.
    (r22,) = _md_spawn(4, scenes, [job((2, 2), "c3", cfg3, ivp)])
    sharded["2x2"] = _md_layout(card, "multi-device 2x2", r22, "gloo",
                                ("tile-sharded", "pallas"), ms3, k1b)
    _md_combined("multi-device 2x2", r22, ref3, img3)

    # (g) the dry run: parallel/entry.py::dryrun_multichip.
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(4, device=dev.type,
                                 timeout_s=MD_TIMEOUT_S)
    dry_launches = [r["launches"].get(k1b, 0) for r in dry]
    dry_prologue = [(r["launches"].get("tile_frusta", 0),
                     r["launches"].get("cluster_select", 0)) for r in dry]
    _log(f"[multi-device dryrun_multichip(4)] {time.perf_counter() - t0:.1f}"
         f" s; meshes {[r['mesh'] for r in dry]}; {k1b} launches per rank "
         f"{dry_launches}, (tile_frusta, cluster_select) {dry_prologue}")
    if min(dry_launches) == 0 or dry_prologue != [
            (1, 1 + n) for n in dry_launches]:
        raise RuntimeError("dryrun_multichip(4): a rank launched no K1b, "
                           "or not its prologue kernels once per window")

    next(k for k in kernels if k["name"] == k1b)["sharded"] = sharded
    next(k for k in kernels if k["name"] == k1bc)["sharded"] = sharded_c
    _log(f"[phase 20] {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 21: the port's benchmark (rtmm_tpu_torch/bench.py), its three
# kinds of row: primary (the default command, config 3, in a process of
# its own), two-level instanced (config 8) and path-traced (config 5),
# the last two with short orbits.
BENCH_ORBIT = 4
BENCH_TIMEOUT_S = 300
# Launches of each stage of the default row: config 3's 32-frame orbit is
# 32 x 2,040 tiles, one batched launch per call (a warm-up and 4 timed);
# the visit count and the verify's kernel frame one each.
BENCH_LAUNCHES_3 = {"orbit": {"tile_trace_fused": 5, "tile_frusta": 5,
                              "cluster_select": 5},
                    "visits": {"tile_trace_fused": 1, "tile_frusta": 1,
                               "cluster_select": 1},
                    "verify": {"tile_trace_fused": 1, "tile_frusta": 1,
                               "cluster_select": 1}}


def _bench_checks(name, row, kind):
    """A row of rtmm_tpu_torch.bench: bench.py's keys less vs_baseline, a
    positive value and the verify within its budgets."""
    from rtmm_tpu_torch import bench
    _log(f"[bench row {name}] {json.dumps(row)}")
    if tuple(row) != bench.ROW_KEYS[kind]:
        raise RuntimeError(f"bench {name}: keys {tuple(row)}, expected "
                           f"{bench.ROW_KEYS[kind]}")
    if not (row["value"] > 0 and row["verify_npix"] <= row["verify_budget"]
            and row["verify_nbig"] <= row["verify_big_budget"]):
        raise RuntimeError(f"bench {name}: row fails: {row}")


def phase_bench():
    """python3 -m rtmm_tpu_torch.bench (config 3) as a subprocess, its
    row and per-stage launches held to bench.py's; then the module's
    config 8 and config 5 rows in this process with 4-frame orbits, their
    launches counted from 0."""
    from rtmm_tpu_torch import bench

    t_phase = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rtmm_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    _log(f"[bench config 3] rc {proc.returncode}, "
         f"{time.perf_counter() - t_phase:.1f} s; stderr:\n"
         f"{proc.stderr.strip()[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"bench config 3: rc {proc.returncode}: "
                           f"{proc.stdout[-500:]}")
    row = json.loads(lines[-1])
    _bench_checks("config 3", row, "image")
    if abs(row["visits"] - EXPECTED_VISITS) > VISITS_RTOL * EXPECTED_VISITS:
        raise RuntimeError(f"bench config 3: visits {row['visits']}")
    tag = "[bench launches] "
    launches = json.loads(next(line for line in proc.stderr.splitlines()
                               if line.startswith(tag))[len(tag):])
    for stage, want in BENCH_LAUNCHES_3.items():
        if launches.get(stage) != want:
            raise RuntimeError(f"bench config 3 {stage}: launches "
                               f"{launches.get(stage)}, expected {want}")
    for n, kind, kernels in ((8, "instanced", ("tile_trace_raw",
                                               "tile_frusta",
                                               "cluster_select")),
                             (5, "pathtrace", ("tile_trace_raw",
                                               "group_trace", "pt_primary",
                                               "pt_bounce", "tile_frusta",
                                               "cluster_select"))):
        t0 = time.perf_counter()
        _reset_all()
        stages = bench._Stages("cuda")
        row = bench.run_row(n, "cuda", frames=BENCH_ORBIT, stages=stages)
        seconds = {k: round(v, 3) for k, v in stages.seconds.items()}
        _log(f"[bench config {n}] {BENCH_ORBIT}-frame orbits, "
             f"{time.perf_counter() - t0:.1f} s: stage seconds {seconds}, "
             f"launches {stages.launches}")
        _bench_checks(f"config {n}", row, kind)
        if any(not stages.launches["orbit"].get(k) for k in kernels):
            raise RuntimeError(f"bench config {n}: the orbit launched "
                               f"{stages.launches['orbit']}, not {kernels}")
    _log(f"[phase 21] {time.perf_counter() - t_phase:.1f} s")


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

    def counted(kernel: str, frusta: int = 0, select: int = 0) -> int:
        """Launches of `kernel` since the last reset, beside `frusta`
        tile_frusta and `select` cluster_select launches; every other
        kernel must not have launched."""
        return _expect_launches(kernel, {kernel: None,
                                         **_prologue(frusta, select)})[kernel]

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
        path = _save_config3(tmp)
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
    _reset_all()
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
    launches = counted("tile_trace_fused", 7, 7)
    main_prologue = _expect_launches("main path", {
        "tile_trace_fused": 7, **_prologue(7, 7)})
    _log(f"[main path] launches of tile_trace: {launches} (1 frame + "
         f"1 orbit of {ORBIT_FRAMES} + 2 render_u8 + 3 pipelined), of "
         f"tile_frusta and cluster_select one each per launch")
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
    batch = tile_trace.frames_inputs(scene, ivps, cfg, kc)

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
    entry9, scene9, scene6 = phase_config9(card, ivp, cfg, counted, geo)
    kernels.append(entry9)
    # -- 6b. the batched frame prologue (K1a, K1c) ---------------------------
    kernels[0]["batched_prologue"] = phase_batched_prologue(
        card, {"config 3": scene, "config 9": scene9, "config 6": scene6},
        cfg)
    # -- 6c. the prologue kernels against their plain versions -------------
    phase_prologue_kernels(card, {"config 3": scene, "config 6": scene6},
                           cfg)
    del scene6
    # -- 7. windowed walks (K1b) ---------------------------------------------
    kernels.append(phase_windowed3(card, scene, ivp, cfg, counted, img_main,
                                   stats["kernel_unit_visits"]))
    kernels.append(phase_windowed7(card, ivp, cfg, counted))
    # -- 7c-d. config 7 at full size (K1b + K1c); configs 1, 2, 11 (K1a) ------
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    kernels.append(phase_config7(card, ivp, cfg, counted))
    torch.cuda.empty_cache()
    _log(f"[config 7] scene freed: {held / 2**20:.1f} MiB allocated on the "
         f"card before the phase, {torch.cuda.memory_allocated() / 2**20:.1f} "
         f"after; {torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved")
    kernels[0]["configs_1_2_11"] = phase_small_configs(card, counted)
    _log(f"[phases 7c-7d] {time.perf_counter() - t0:.1f} s")
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
    (entry5, img5, bytes5, mesh5, cfg5, pt5, ivp5,
     pt_entries) = phase_config5(card)
    kernels.append(entry5)
    kernels.append(phase_config5_compressed(card, mesh5, cfg5, pt5, ivp5,
                                            img5, bytes5, pt_entries))
    kernels.extend(pt_entries)
    # -- 16-19. per-ray backend, stats, perray engine, debug and cache -------
    t0 = time.perf_counter()
    scene_h = phase_perray(card, mesh, img_main, ivp, cfg)
    phase_stats(card, scene_h, ivp, ivps, cfg)
    arrays_h = scene_mod.scene_arrays(scene_h)
    del scene_h
    phase_perray_engine(card, mesh5)
    phase_debug_cache(card, scene, img_main, ivp, cfg)
    _log(f"[phases 16-19] {time.perf_counter() - t0:.1f} s")
    # -- 20. multi-device rendering -----------------------------------------
    phase_multidevice(card, scene, ivp, cfg, scene9, arrays_h, kernels)
    # -- 21. the port's benchmark -------------------------------------------
    phase_bench()
    kernels.extend(_prologue_entries(main_prologue))
    _log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
