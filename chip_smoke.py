"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card and build: the card's name and power limit; nvcc builds every
     kernel of rtmm_tpu_torch/csrc (one process per source, started
     together) and ptxas's register/shared-memory/spill report is printed;
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
     32-frame orbit, the plain version, and the kernel's bound.

The last lines are the kernel table as JSON, the card as nvidia-smi
reports it, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
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
# float32 operations per (ray, leaf) test, counted from process_unit in
# csrc/tile_trace.cu: four 6-term dot products (4 x (6 mul + 5 add) = 44),
# one division, four quotient products, four window compares, one select,
# one running-minimum compare. Per (ray, unit) visit add the recentered
# moment (9) and the fold (tb select, subtract, compare, take = 4).
OPS_PER_RAY_LEAF = 44 + 1 + 4 + 4 + 1 + 1
OPS_PER_RAY_VISIT = 64 * OPS_PER_RAY_LEAF + 9 + 4


def _log(msg: str) -> None:
    print(msg, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _camera(tb_yaw: float, cfg):
    from rtmm_tpu_torch.utils import camera
    tb = camera.Trackball()
    tb.set_camera([0.0, 0.0, 0.0],
                  [np.radians(-30.0), np.radians(tb_yaw), 0.0], 3.0)
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
    tile_trace.LAUNCHES = 0
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
    launches = tile_trace.LAUNCHES
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
    kc = tile_trace._window(scene, cfg)
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

    kernels = [{
        "name": "tile_trace_fused",
        "route": "cuda",
        "source": "rtmm_tpu_torch/csrc/tile_trace.cu",
        "replaces": "rtmm_tpu/ops/pallas_tiled.py:1336",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    _log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
