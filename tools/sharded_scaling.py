"""Time the tile-sharded path over NCCL, one rank per card.

    python3 tools/sharded_scaling.py [--ranks N]

Needs N NVIDIA cards on one host (4 by default): the ranks are spawned by
parallel/launch.py with the NCCL backend, each on its own card, so no
tensor goes through the host. With chip_smoke.py's scenes and settings
at 1920x1080 it renders config 3 in windows of 4 clusters on the
layouts N x 1, 2 x N/2 (N even) and 1 x N, and config 9 compressed on
1 x N, through render_tiled_sharded's trace kernel (K1b; K1b + K1c on
config 9). Each layout is held to the single card's windowed trace as
chip_smoke.py's phase 20 holds it: rays-only layouts bit for bit (t,
summed normals, visits), scene layouts by the two-tier gate with the
rays whose t or normal differs printed. It prints per layout ms per
frame (CUDA events per rank, the host clock on rank 0) beside the single
card's, K1b launches (one per window of the rank's walk; none on a rank
whose tiles hit no cluster) and scene MiB per rank, then a JSON summary and
the cards as nvidia-smi reports them. Exits non-zero without N cards or
on a mismatch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    n = ap.parse_args().ranks
    if torch.cuda.device_count() < n:
        print(f"sharded_scaling: {n} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from rtmm_tpu_torch.config import RenderConfig
    from rtmm_tpu_torch.io import loader
    from rtmm_tpu_torch.models import procedural, scene as scene_mod
    from rtmm_tpu_torch.ops import _build

    _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = loader.load_micromesh(cs._save_config3(tmp))
    scene = scene_mod.build_device_scene(mesh, device="cuda")
    scene9 = scene_mod.build_device_scene(
        procedural.make_plane(grid=(160, 160), level=2, amplitude=0.05),
        compressed=True, device="cuda")
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT)
    cfg3 = dataclasses.replace(
        cfg, kernel_clusters_per_window=cs.CLUSTERS_PER_WINDOW_3)
    ivp = cs._camera(25.0, cfg)
    card = cs._card_line()
    ref3, img3, ms3 = cs._md_single(scene, cfg3, ivp)
    ref9, img9, ms9 = cs._md_single(scene9, cfg, ivp)
    layouts = [(n, 1), (1, n)] + ([(2, n // 2)] if n % 2 == 0 and n > 2
                                  else [])
    jobs = [cs._md_job(shape, "c3", cfg3, ivp) for shape in layouts]
    jobs.append(cs._md_job((1, n), "c9", cfg, ivp))
    results = cs._md_spawn(n, {
        "c3": scene_mod.scene_arrays(scene),
        "c9": scene_mod.scene_arrays(scene9)}, jobs)
    summary = {}
    for job, res in zip(jobs, results):
        n_rays, n_scene = job["shape"]
        c9 = job["scene"] == "c9"
        name = f"config {9 if c9 else 3} {n_rays}x{n_scene}"
        summary[name] = cs._md_layout(
            card, name, res, "nccl", ("tile-sharded", "pallas"),
            ms9 if c9 else ms3, "tile_trace_windowed_compressed" if c9
            else "tile_trace_windowed", every_rank=False)
        if n_scene == 1:
            cs._md_rows_equal(name, res, ref3)
        else:
            cs._md_combined(name, res, ref9 if c9 else ref3,
                            img9 if c9 else img3)
    print(json.dumps(summary))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
