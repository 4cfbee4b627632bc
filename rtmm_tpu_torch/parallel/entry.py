"""Entry points of the multi-device path, and the functions its ranks run.

  entry(device)              a single-device render step and its example
                             arguments;
  dryrun_multichip(n)        n ranks render one tiny frame through the
                             tile-sharded renderer with the trace kernel
                             (rays x scene mesh, the closest-hit combine
                             across "scene");
  render_jobs(scenes, jobs)  what a rank runs for a list of sharded
                             renders (tests and chip_smoke.py start it
                             with launch.spawn and compare the results).

The counterparts of the JAX package's __graft_entry__.py. Functions that
ranks run live here, in the package, so that a spawned rank imports
torch and this package only.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models import procedural, scene as scene_mod
from ..ops import culling
from ..utils import camera, spans
from . import launch, sharding


def _example_scene(level: int = 2, device="cuda", subdivisions: int = 0):
    mesh = procedural.make_icosphere(subdivisions=subdivisions, level=level,
                                     amplitude=0.1)
    return scene_mod.build_device_scene(mesh, device=device)


def _example_ivp(width: int, height: int) -> np.ndarray:
    tb = camera.Trackball()
    tb.set_camera([0.0, 0.0, 0.0],
                  [np.radians(-30.0), np.radians(20.0), 0.0], 3.0)
    return camera.inv_view_proj(tb, width, height)


def entry(device="cuda"):
    """Returns (fn, example_args): one 128x128 frame of a level-2
    icosphere through the kernel-free tile pipeline, on `device`."""
    from ..render.renderer import render_image

    cfg = RenderConfig(width=128, height=128, ray_chunk=4096,
                       max_candidates=4, pipeline="tile")
    scene = _example_scene(device=device)
    ivp = torch.as_tensor(_example_ivp(cfg.width, cfg.height),
                          dtype=torch.float32, device=device)
    return functools.partial(render_image, cfg=cfg), (scene, ivp)


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    n_scene = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_rays = n_devices // n_scene
    mesh = sharding.make_mesh(n_rays, n_scene, device_type)
    # One pixel tile per rays rank, so that every rank traces tiles of
    # its own.
    tx = 2 if n_rays % 2 == 0 else 1
    cfg = RenderConfig(width=culling.TILE_W * tx,
                       height=culling.TILE_H * (n_rays // tx),
                       ray_chunk=256, max_candidates=2)
    # Two clusters (an 80-triangle level-3 icosphere), so that each of two
    # scene shards walks one of its own.
    scene = _example_scene(level=3, device="cpu", subdivisions=1)
    if scene.num_triangles % n_scene:
        raise RuntimeError("the example scene does not split over 'scene'")
    renderer = sharding.ShardedRenderer(scene=scene, cfg=cfg, mesh=mesh,
                                        pipeline="tile", backend="pallas")
    if (renderer.chosen_pipeline, renderer.chosen_backend) != (
            "tile-sharded", "pallas"):
        raise RuntimeError(f"dry run chose {renderer.chosen_pipeline} / "
                           f"{renderer.chosen_backend}, not tile-sharded "
                           "/ pallas")
    spans.reset_launches()
    img, stats = renderer.render(_example_ivp(cfg.width, cfg.height),
                                 with_stats=True)
    _sync(img.device)
    if tuple(img.shape) != (cfg.height, cfg.width, 3) or not bool(
            torch.isfinite(img).all()):
        raise RuntimeError("dry run frame malformed")
    return {"mesh": (n_rays, n_scene), "image": img.cpu().numpy(),
            "visits": int(stats["visits"].sum()),
            "launches": _launches()}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = launch.DEFAULT_TIMEOUT_S) -> list:
    """Spawn n_devices ranks (2 scene shards when n_devices is even) and
    render one frame through ShardedRenderer(pipeline="tile",
    backend="pallas"): on CUDA each rank launches the windowed trace
    kernel on its shard, on the CPU its plain version. Raises if the
    renderer chose another path or the frame is malformed; returns each
    rank's {"mesh", "image", "visits" (its shard's unit visits), "launches"
    (the kernels' launches of the frame)}."""
    device_type = torch.device(device).type
    return launch.spawn(_dryrun_rank, n_devices, device_type,
                        args=(n_devices, device_type), timeout_s=timeout_s)


def _launches() -> dict:
    """The kernels' launches since spans.reset_launches()."""
    return {k: n for k, n in spans.launches().items() if n}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_jobs(scenes: dict, jobs: list[dict]) -> list[dict]:
    """Run sharded renders on this rank, one per job, in order; every
    rank of the world runs the same jobs.

    scenes: name -> models/scene.scene_arrays of a host scene. A job:
      "shape"     (n_rays, n_scene), covering the world;
      "device"    "cuda" or "cpu";
      "scene", "cfg", "ivp" (4x4), "pipeline", "backend" as
                  ShardedRenderer takes them;
      "reps"      frames to time after the counted one (default 0).

    Returns one dict per job: rank, mesh indices, the process group's
    backend, the chosen pipeline and backend, shard_bytes, the kernels'
    launches of the counted frame (their counts set to 0 just before
    it), its image and this rank's trace (ShardedRenderer.render's
    stats) as NumPy, and with reps the ms per frame: "ms_events" (CUDA
    events on this rank) and "ms_wall" (host clock, from a barrier to the
    last rank's synchronise)."""
    host = {}
    out = []
    for job in jobs:
        mesh = sharding.make_mesh(*job["shape"], device_type=job["device"])
        if job["scene"] not in host:
            host[job["scene"]] = scene_mod.scene_from_arrays(
                scenes[job["scene"]], device="cpu")
        renderer = sharding.ShardedRenderer(
            scene=host[job["scene"]], cfg=job["cfg"], mesh=mesh,
            pipeline=job.get("pipeline", "auto"),
            backend=job.get("backend", "auto"))
        dev = mesh.device
        spans.reset_launches()
        img, stats = renderer.render(job["ivp"], with_stats=True)
        _sync(dev)
        res = {"rank": mesh.rank, "rays_index": mesh.rays_index,
               "scene_index": mesh.scene_index, "backend": mesh.backend,
               "chosen": (renderer.chosen_pipeline,
                          renderer.chosen_backend),
               "shard_bytes": renderer.shard_bytes(),
               "launches": _launches(),
               "image": img.cpu().numpy(),
               "trace": {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                             else v) for k, v in stats.items()}}
        reps = job.get("reps", 0)
        if reps:
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            for _ in range(reps):
                renderer.render(job["ivp"])
            if dev.type == "cuda":
                stop.record()
                stop.synchronize()
                res["ms_events"] = start.elapsed_time(stop) / reps
            _sync(dev)
            dist.barrier()
            res["ms_wall"] = (time.perf_counter() - t0) * 1e3 / reps
        out.append(res)
    return out
