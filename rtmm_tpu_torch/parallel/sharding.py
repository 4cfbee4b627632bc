"""Multi-device rendering: rays and scene sharded over torch.distributed.

The port of the JAX package's parallel/sharding.py. Its jax.sharding.Mesh
becomes a 2-D mesh of the ranks of the current process group:

  axis "rays"  - data-parallel pixel tiles or rows (no communication
                 until the image is gathered);
  axis "scene" - the scene tables sliced across ranks (for scenes larger
                 than one card's memory); per-ray closest hits are
                 combined across this axis (an all_gather and an argmin,
                 the first shard winning ties).

Rank = r * n_scene + s, as the JAX package lays its device grid out
row-major. Where JAX's shard_map hands each device its slice of the
scene, each rank here uploads only its own slice (shard_scene), and
every rank returns the whole (H, W, 3) image, gathered over "rays".

Three pipelines, as in the JAX package:
  * render_sharded       - per-ray reference backend, rays x scene;
  * render_tiled_gspmd   - rays only, the scene replicated, the
                           kernel-free XLA tile backend;
  * render_tiled_sharded - the tile trace over both axes: tiles over
                           "rays", clusters and unit tables over
                           "scene", each shard's cluster-window walk run
                           by the windowed trace kernel (K1b; K1b + K1c
                           on a compressed scene), then the closest-hit
                           combine.

Collectives are the list form of all_gather. Gloo carries them on host
tensors: a CUDA tensor on a gloo mesh is staged through the host
explicitly (gloo's CUDA support covers broadcast and all_reduce only).
NCCL gathers on the card. Ranks are started by parallel/launch.py
(spawn), or by torchrun with an explicit backend.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.scene import META_FIELDS, DeviceScene
from ..ops import culling, raygen, shading, tile_trace, tiled, traversal
from ..ops.tiled import TILE
from ..render.renderer import _pick_chunk
from . import launch

BIG = 1e30

_UNIT_FIELDS = ("unit_aabb_min", "unit_aabb_max", "unit_valid",
                "unit_leaf_idx", "unit_qn", "unit_n", "unit_e2w2",
                "unit_nrm", "unit_nrm_pad", "unit_q16", "unit_grid")
_CLUSTER_FIELDS = ("cluster_aabb_min", "cluster_aabb_max", "cluster_valid",
                   "cluster_unit_meta")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("rays", "scene") grid of the process group's ranks, rank =
    r * n_scene + s. rays_group holds the n_rays ranks of this rank's
    scene shard s (by r); scene_group the n_scene ranks of its tiles r
    (by s)."""

    n_rays: int
    n_scene: int
    rank: int
    device: torch.device
    backend: str
    rays_group: object
    scene_group: object

    @property
    def rays_index(self) -> int:
        return self.rank // self.n_scene

    @property
    def scene_index(self) -> int:
        return self.rank % self.n_scene


def make_mesh(n_rays: int | None = None, n_scene: int = 1,
              device_type: str = "cuda") -> Mesh:
    """The mesh over every rank of the current process group (started by
    launch.spawn, or torchrun); every rank calls it, in the same order
    as any other make_mesh. n_rays defaults to world // n_scene. The
    group's backend must suit the devices (launch.choose_backend): NCCL
    with a card per rank, gloo when ranks share a card or run on the
    CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the "
                           "ranks with parallel.launch.spawn or torchrun")
    world = dist.get_world_size()
    rank = dist.get_rank()
    if n_rays is None:
        n_rays = world // n_scene
    if n_rays < 1 or n_scene < 1 or n_rays * n_scene != world:
        raise ValueError(f"a {n_rays} x {n_scene} mesh does not cover "
                         f"{world} ranks")
    backend = launch.choose_backend(world, device_type, dist.get_backend())
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = launch.rank_device(local, device_type)
    rays_group = scene_group = None
    for s in range(n_scene):
        g = dist.new_group([r * n_scene + s for r in range(n_rays)])
        if s == rank % n_scene:
            rays_group = g
    for r in range(n_rays):
        g = dist.new_group([r * n_scene + s for s in range(n_scene)])
        if r == rank // n_scene:
            scene_group = g
    return Mesh(n_rays, n_scene, rank, device, backend, rays_group,
                scene_group)


def _all_gather(x: torch.Tensor, group, mesh: Mesh) -> list[torch.Tensor]:
    """Every member's x, in the group's rank order."""
    stage = mesh.backend == "gloo" and x.is_cuda
    src = (x.cpu() if stage else x).contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts] if stage else parts


def _closest_hit(t: torch.Tensor, n: torch.Tensor, mesh: Mesh):
    """Combine (t (...,), n (..., 3)) across the scene axis: the least t,
    the first shard winning ties (torch.argmin returns the first
    minimum), with that shard's normal."""
    t_all = torch.stack(_all_gather(t, mesh.scene_group, mesh))
    n_all = torch.stack(_all_gather(n, mesh.scene_group, mesh))
    best = torch.argmin(t_all, dim=0)
    t = torch.take_along_dim(t_all, best[None], dim=0)[0]
    n = torch.take_along_dim(n_all, best[None, ..., None], dim=0)[0]
    return t, n


# ----------------------------------------------------------------------
# Scene shards.

def _pad_scene_for_scene_axis(scene: DeviceScene, s: int) -> DeviceScene:
    """Pad unit and cluster tables with invalid entries so that whole
    clusters split evenly over the scene axis (each shard keeps aligned
    cluster -> unit ranges)."""
    pad_cl = (-scene.num_clusters) % s
    if pad_cl == 0:
        return scene
    updates = {}
    for name in _UNIT_FIELDS + _CLUSTER_FIELDS:
        a = getattr(scene, name)
        if a is None:
            continue
        n = pad_cl * (culling.UNITS_PER_CLUSTER if name in _UNIT_FIELDS
                      else 1)
        fill = (BIG if name.endswith("aabb_min")
                else -BIG if name.endswith("aabb_max")
                else -1 if name == "unit_leaf_idx"   # -1 = no-leaf sentinel
                else 0)
        pad = torch.full((n, *a.shape[1:]), fill, dtype=a.dtype,
                         device=a.device)
        updates[name] = torch.cat([a, pad])
    return dataclasses.replace(scene, **updates)


def _check_divisible(scene: DeviceScene, n_scene: int) -> None:
    if scene.num_triangles % n_scene:
        raise ValueError("triangle padding must divide over the 'scene' axis")


def shard_scene(scene: DeviceScene, n_scene: int, index: int,
                device=None) -> DeviceScene:
    """Scene shard `index` of n_scene, as the JAX package's shard_map
    hands it to a device, with only the shard's tensors on `device`
    (default: the scene's).

    Clusters are first padded with invalid entries to a multiple of
    n_scene. Then every per-triangle table is sliced on axis 0; unit
    tables are sliced when the unit count divides, cluster tables when
    the cluster count does, else replicated; unit_gmat (one gather matrix
    for the whole scene) is replicated; absent tables stay None. Slices
    are raw: no index is re-based, so unit c * 64 + k of a shard is unit
    k of its local cluster c (cluster_unit_meta holds no indices)."""
    _check_divisible(scene, n_scene)
    if not 0 <= index < n_scene:
        raise ValueError(f"shard {index} of {n_scene}")
    device = scene.device if device is None else torch.device(device)
    scene = _pad_scene_for_scene_axis(scene, n_scene)
    u_ok = scene.num_units % n_scene == 0
    c_ok = scene.num_clusters % n_scene == 0
    tables = {}
    for f in dataclasses.fields(scene):
        a = getattr(scene, f.name)
        if f.name in META_FIELDS or a is None:
            continue
        if f.name in _CLUSTER_FIELDS:
            split = c_ok
        elif f.name in _UNIT_FIELDS:
            split = u_ok
        else:
            split = f.name != "unit_gmat"
        if split:
            rows = a.shape[0] // n_scene
            a = a[index * rows:(index + 1) * rows]
        tables[f.name] = a.to(device, copy=True)
    return dataclasses.replace(scene, **tables)


# ----------------------------------------------------------------------
# Pipelines.

def _tile_grid(cfg: RenderConfig):
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    return pw, ph, tx, ty, tx * ty


def _resolve_backend(backend: str, mesh: Mesh) -> str:
    """"auto" is "xla" on a CPU mesh and "pallas" on a CUDA mesh."""
    if backend == "auto":
        return "xla" if mesh.device.type == "cpu" else "pallas"
    if backend not in ("pallas", "xla"):
        raise ValueError(f"backend is 'pallas', 'xla' or 'auto', not "
                         f"{backend!r}")
    return backend


def _gather_tiles(colors: torch.Tensor, starts, cfg: RenderConfig,
                  mesh: Mesh) -> torch.Tensor:
    """Every rays rank's (n_local, TILE, 3) colors into the (H, W, 3)
    image, by explicit tile index: overlapping windows write identical
    values."""
    pw, ph, tx, ty, n_tiles = _tile_grid(cfg)
    full = colors.new_zeros((n_tiles, TILE, 3))
    for start, part in zip(starts,
                           _all_gather(colors, mesh.rays_group, mesh)):
        full[start:start + part.shape[0]] = part
    img = (full.reshape(ty, tx, culling.TILE_H, culling.TILE_W, 3)
           .permute(0, 2, 1, 3, 4).reshape(ph, pw, 3))
    return img[:cfg.height, :cfg.width]


def _shade_tiles(best_t, best_n, dirs, cfg: RenderConfig):
    hit = best_t < BIG
    nrm = best_n / torch.clamp_min(culling._norm(best_n, keepdim=True),
                                   1e-20)
    return shading.shade_or_miss(hit, nrm, -dirs, cfg)


def _ray_frame(shard: DeviceScene, ivp, cfg: RenderConfig, mesh: Mesh):
    n_rays = mesh.n_rays
    if cfg.height % n_rays:
        raise ValueError("height must divide over the 'rays' axis")
    width = cfg.width
    rows = cfg.height // n_rays
    row0 = mesh.rays_index * rows
    o, d = raygen.generate_rays(ivp, width, cfg.height, device=shard.device,
                                rows=(row0, rows))
    chunk = _pick_chunk(cfg, shard)
    t, nrm, hit = (torch.cat(parts) for parts in zip(*(
        traversal.trace(shard, o[c:c + chunk], d[c:c + chunk], cfg)
        for c in range(0, o.shape[0], chunk))))
    t = torch.where(hit, t, BIG)
    if mesh.n_scene > 1:
        t, nrm = _closest_hit(t, nrm, mesh)
        hit = t < BIG
    color = shading.shade_or_miss(hit, nrm, -d, cfg).reshape(rows, width, 3)
    img = torch.cat(_all_gather(color, mesh.rays_group, mesh))
    return img, {"t": t, "n": nrm, "row0": row0}


def render_sharded(scene: DeviceScene, inv_view_proj, cfg: RenderConfig,
                   mesh: Mesh) -> torch.Tensor:
    """Per-ray reference path over the mesh. Returns (H, W, 3) on the
    rank's device, the whole frame on every rank.

    Each rays rank traces its cfg.height / n_rays pixel rows with
    ops/traversal.py on its scene shard (built with hierarchy=True), in
    chunks; scene shards combine their closest hits. Requires the height
    to divide over "rays" and the padded triangle count over "scene"."""
    _check_divisible(scene, mesh.n_scene)
    shard = shard_scene(scene, mesh.n_scene, mesh.scene_index, mesh.device)
    return _ray_frame(shard, inv_view_proj, cfg, mesh)[0]


def _gspmd_frame(scene: DeviceScene, ivp, cfg: RenderConfig, mesh: Mesh):
    _, _, _, _, n_tiles = _tile_grid(cfg)
    if n_tiles % mesh.n_rays:
        raise ValueError("tile count must divide over the 'rays' axis")
    n_local = n_tiles // mesh.n_rays
    tile0 = mesh.rays_index * n_local
    fi = tiled.build_frame_inputs(scene, ivp, cfg, need_q_frame=True,
                                  tiles=(tile0, n_local))
    best_t, best_n = tiled.xla_trace_frame(scene, fi, cfg)
    colors = _shade_tiles(best_t, best_n, fi.dirs, cfg)
    starts = range(0, n_tiles, n_local)
    return _gather_tiles(colors, starts, cfg, mesh), {
        "t": best_t, "n": best_n, "tile0": tile0}


def render_tiled_gspmd(scene: DeviceScene, inv_view_proj,
                       cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """Data-parallel tiled rendering, the scene replicated.

    GSPMD (sharding annotations that let XLA partition the tile axis) has
    no PyTorch counterpart; this keeps its name, its pipeline and its
    split: each rays rank runs the kernel-free XLA tile backend
    (tiled.xla_trace_frame: candidate windows of trace_candidate) on its
    contiguous n_tiles / n_rays tiles, with the prologue of those tiles
    only, and no collective until the image is gathered. Requires the tile count to
    divide over "rays"."""
    full = shard_scene(scene, 1, 0, mesh.device)
    return _gspmd_frame(full, inv_view_proj, cfg, mesh)[0]


def _tiled_frame(shard: DeviceScene, ivp, cfg: RenderConfig, mesh: Mesh,
                 backend: str):
    _, _, _, _, n_tiles = _tile_grid(cfg)
    # Tiles per rays rank; window starts clamp so every window stays in
    # the frame (trailing ranks re-trace a few overlap tiles).
    n_local = -(-n_tiles // mesh.n_rays)
    starts = np.minimum(np.arange(mesh.n_rays) * n_local,
                        n_tiles - n_local).tolist()
    tile0 = starts[mesh.rays_index]
    # The prologue of this rank's tiles only, culled against the shard's
    # clusters, with the shard's exit box.
    fi = tiled.build_frame_inputs(shard, ivp, cfg,
                                  need_q_frame=backend == "xla",
                                  tiles=(tile0, n_local),
                                  kernels=backend == "pallas")
    stats = {"tile0": tile0}
    if backend == "pallas":
        # The windowed trace kernel on this shard: its cluster cull, exit
        # box and window capacity are the shard's own, and the cluster
        # indices it walks are shard-local, as are the tables it reads.
        frus = fi.frus
        raymat = fi.raymat.transpose(1, 2).contiguous()
        kc = tile_trace.clusters_per_window(shard, cfg)
        best_t, n, visits, _, windows = tile_trace.trace_windows(
            shard, fi, frus, raymat, cfg, kc)
        best_n = n.transpose(1, 2)
        stats.update(visits=visits, windows=windows)
    else:
        best_t, best_n = tiled.xla_trace_frame(shard, fi, cfg)
    if mesh.n_scene > 1:
        best_t, best_n = _closest_hit(best_t, best_n, mesh)
    stats.update(t=best_t, n=best_n)
    colors = _shade_tiles(best_t, best_n, fi.dirs, cfg)
    return _gather_tiles(colors, starts, cfg, mesh), stats


def render_tiled_sharded(scene: DeviceScene, inv_view_proj,
                         cfg: RenderConfig, mesh: Mesh,
                         backend: str = "auto") -> torch.Tensor:
    """The tile trace over both mesh axes. Returns (H, W, 3) on the
    rank's device, the whole frame on every rank.

    Flat tiles split over "rays" in windows of ceil(n_tiles / n_rays),
    the start clamped to the frame, so any frame size fits any mesh.
    Clusters and unit tables split over "scene": each shard culls and
    traces only its slice of the scene's units against its own exit box,
    then the shards' closest hits combine; shading uses the vector
    shade_or_miss on the normalised summed normal.

    backend: "pallas" runs the windowed trace kernel (K1b, with K1c's
    derive on a compressed scene; its plain version on a CPU mesh);
    "xla" the kernel-free XLA tile backend; "auto" is "xla" on a CPU
    mesh and "pallas" on a CUDA mesh."""
    backend = _resolve_backend(backend, mesh)
    _check_divisible(scene, mesh.n_scene)
    shard = shard_scene(scene, mesh.n_scene, mesh.scene_index, mesh.device)
    return _tiled_frame(shard, inv_view_proj, cfg, mesh, backend)[0]


@dataclasses.dataclass
class ShardedRenderer:
    """Multi-device frame renderer: picks the pipeline once, keeps this
    rank's scene shard (or, for tile-gspmd, the whole scene) on its
    device, and renders frames with render()."""

    scene: DeviceScene
    cfg: RenderConfig
    mesh: Mesh

    pipeline: str = "auto"   # "ray" | "tile" | "auto"
    backend: str = "auto"    # tile-sharded trace: "pallas" | "xla" | "auto"

    # Resolved at construction: "tile-gspmd" | "tile-sharded" | "ray", and
    # the tile-sharded trace ("pallas" | "xla", None otherwise). A caller
    # that needs the trace kernel asserts these rather than trusting the
    # defaults: there is no silent downgrade.
    chosen_pipeline: str = dataclasses.field(init=False, default="")
    chosen_backend: str | None = dataclasses.field(init=False, default=None)

    def __post_init__(self):
        *_, n_tiles = _tile_grid(self.cfg)
        n_rays, n_scene = self.mesh.n_rays, self.mesh.n_scene
        gspmd_ok = n_scene == 1 and n_tiles % n_rays == 0
        sharded_ok = self.scene.num_triangles % n_scene == 0
        if self.pipeline not in ("auto", "tile", "ray"):
            raise ValueError(f"pipeline is 'auto', 'tile' or 'ray', not "
                             f"{self.pipeline!r}")
        use_tile = (self.pipeline == "tile"
                    or (self.pipeline == "auto"
                        and (gspmd_ok or sharded_ok)))
        if self.pipeline == "tile" and not (gspmd_ok or sharded_ok):
            raise ValueError(
                "pipeline='tile' requested but neither the gspmd nor the "
                "sharded tiled path fits this mesh (triangle padding "
                f"{self.scene.num_triangles} % scene axis {n_scene} != 0)")
        if use_tile and gspmd_ok and self.backend != "pallas":
            self.chosen_pipeline = "tile-gspmd"
            self._scene = shard_scene(self.scene, 1, 0, self.mesh.device)
        else:
            self.chosen_pipeline = "tile-sharded" if use_tile else "ray"
            if use_tile:
                self.chosen_backend = _resolve_backend(self.backend,
                                                       self.mesh)
            self._scene = shard_scene(self.scene, n_scene,
                                      self.mesh.scene_index,
                                      self.mesh.device)

    def render(self, inv_view_proj, with_stats: bool = False):
        """The (H, W, 3) frame on the rank's device; with_stats: also this
        rank's trace, a dict: "t" and "n" (its tiles' or rows' closest-hit
        t and summed unnormalised normals after the scene combine),
        "tile0" or "row0", and, on the pallas trace, the shard's
        per-tile "visits" and its "windows"."""
        ivp = torch.as_tensor(inv_view_proj,
                              dtype=torch.float32).to(self.mesh.device)
        if self.chosen_pipeline == "tile-gspmd":
            out = _gspmd_frame(self._scene, ivp, self.cfg, self.mesh)
        elif self.chosen_pipeline == "tile-sharded":
            out = _tiled_frame(self._scene, ivp, self.cfg, self.mesh,
                               self.chosen_backend)
        else:
            out = _ray_frame(self._scene, ivp, self.cfg, self.mesh)
        return out if with_stats else out[0]

    def shard_bytes(self) -> int:
        """Bytes of the scene tensors this rank holds on its device."""
        return self._scene.device_bytes()
