"""Multi-instance scenes — the TLAS analog with per-instance transforms.

The reference only ever builds a single identity-transform instance
(src/GPUMesh.cpp:244-252); this module provides the full two-level story:
N instances of a base micro-mesh, each with a rigid + uniform-scale
transform. Two strategies:

* bake_instances — materialize world-space copies of the scene tables.
  Fastest to trace (one flat scene through the fused kernel) but device
  memory is O(instances x scene): right for a handful of instances.

* render_instanced — TRUE two-level traversal (the reference's TLAS ->
  ray-transform -> shared-BLAS model, src/GPUMesh.cpp:238-278): the
  per-frame rays go into each instance's object space (apex/dirs rotate,
  t scales by 1/s — the shared-apex bilinear MT identities survive
  rigid+uniform-scale exactly) and trace the SHARED object-space cluster
  hierarchy, min-combining closest hits across instances in world t.
  Device memory is O(scene + instances). Per-instance near/far clips act
  in object units (world t_min*s_i .. t_max*s_i) — a sub-epsilon deviation
  from the baked path at the near plane.

  The merged path gives every (instance, tile) pair that sees geometry one
  row of ONE raw-mode kernel launch (tile_trace.trace_raw, in-kernel
  raygen + object transform). The serial path scans the instances, one
  windowed trace each; it also backs the merged launch when the summed
  footprint overflows its row pool, and renders scenes whose cluster
  lists need several windows.

Every 3x3 product is written as three 3-term sums, left to right — the
order the trace kernel uses for its in-kernel object transform — never as
a matmul or a .sum(-1), whose order differs between devices.

(The JAX package's CPU stand-in for its kernel, the XLA tile backend, and
its environment A/B knobs stay behind: here the CPU path is the plain
version of the same kernel.)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig
from ..models import scene as scene_mod
from ..models.scene import DeviceScene
from ..ops import _f32, culling, prologue, raygen, shading, tile_trace, tiled
from ..ops.culling import UNITS_PER_CLUSTER
from ..utils import spans
from .renderer import _quantize

BIG = 1e30
TILE = tiled.TILE


@dataclasses.dataclass(frozen=True)
class Instance:
    """Rigid + uniform-scale transform (rotation, translation, scale)."""

    rotation: np.ndarray      # (3, 3)
    translation: np.ndarray   # (3,)
    scale: float = 1.0

    @staticmethod
    def identity() -> "Instance":
        return Instance(np.eye(3, dtype=np.float32),
                        np.zeros(3, dtype=np.float32), 1.0)

    @staticmethod
    def from_euler(translation, euler_xyz=(0.0, 0.0, 0.0),
                   scale: float = 1.0) -> "Instance":
        cx, cy, cz = np.cos(euler_xyz)
        sx, sy, sz = np.sin(euler_xyz)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return Instance((rz @ ry @ rx).astype(np.float32),
                        np.asarray(translation, np.float32), float(scale))


def instance_tensors(instances, device="cuda"):
    """(rot (N, 3, 3), trn (N, 3), scl (N,)) float32 tensors on `device`,
    from a list of Instance (anything with rotation, translation and
    scale) or from the (rot, trn, scl) arrays the JAX package holds (NumPy
    or anything np.asarray takes)."""
    if len(instances) and hasattr(instances[0], "rotation"):
        rot = np.stack([i.rotation for i in instances])
        trn = np.stack([i.translation for i in instances])
        scl = np.asarray([i.scale for i in instances])
    else:
        rot, trn, scl = (np.asarray(x) for x in instances)
    n = rot.shape[0]
    if rot.shape != (n, 3, 3) or trn.shape != (n, 3) or scl.shape != (n,):
        raise ValueError(f"instance arrays have shapes {rot.shape}, "
                         f"{trn.shape}, {scl.shape}")
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)
                                  ).to(device) for x in (rot, trn, scl))


def _rot(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R x over the last axis; r (..., 3, 3) broadcasts against x (..., 3)."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([r[..., i, 0] * x0 + r[..., i, 1] * x1
                        + r[..., i, 2] * x2 for i in range(3)], dim=-1)


def _rot_t(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R^T x over the last axis."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    return torch.stack([r[..., 0, i] * x0 + r[..., 1, i] * x1
                        + r[..., 2, i] * x2 for i in range(3)], dim=-1)


# ----------------------------------------------------------------------
# Baking: world-space copies of the scene tables.

def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third bit (Morton; twin of scene.py's)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _morton_leaf_order(centers: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Stable order putting valid leaves first along a Morton curve (twin
    of scene.pack_units's ordering, on the device)."""
    lo = torch.where(valid[:, None], centers, BIG).amin(dim=0)
    hi = torch.where(valid[:, None], centers, -BIG).amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-20)
    q = torch.clamp((centers - lo) / span * 1023.0, 0.0, 1023.0
                    ).to(torch.int64)
    code = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))
    code = torch.where(valid, code, 0x7FFFFFFF)
    return torch.argsort(code, stable=True)


def bake_instances(scene: DeviceScene, instances) -> DeviceScene:
    """Build a world-space DeviceScene containing every instance, on the
    scene's device.

    All tables transform analytically:
      * 3D points p -> s R p + t (leaf verts, plane origins, AABB corners)
      * directions   -> R d (plane frames)
      * object-space lengths/heights scale by s (2D node tables, min/max
        heights — the expanded node verts already have deltas baked in)
      * MT tables (q, n, e2w2) are recomputed from the transformed leaves.
    """
    rot, trn, scl = instance_tensors(instances, scene.device)
    if scene.compressed:
        return _bake_compressed(scene, rot, trn, scl)
    return _bake(scene, rot, trn, scl)


def _cluster_tables(umin, umax, unit_valid) -> dict:
    """Cluster tables over (Morton-ordered, 64-multiple) units: the device
    twin of scene.build_clusters."""
    n_cl = unit_valid.shape[0] // UNITS_PER_CLUSTER
    upc = UNITS_PER_CLUSTER
    cl_mask = unit_valid.reshape(n_cl, upc, 1)
    meta = torch.zeros((n_cl, 8, 128), dtype=torch.float32,
                       device=umin.device)
    meta[:, 0:3, :upc] = umin.reshape(n_cl, upc, 3).transpose(1, 2)
    meta[:, 3:6, :upc] = umax.reshape(n_cl, upc, 3).transpose(1, 2)
    meta[:, 6, :upc] = unit_valid.reshape(n_cl, upc).to(torch.float32)
    return dict(
        cluster_aabb_min=torch.where(
            cl_mask, umin.reshape(n_cl, upc, 3), BIG).amin(dim=1),
        cluster_aabb_max=torch.where(
            cl_mask, umax.reshape(n_cl, upc, 3), -BIG).amax(dim=1),
        cluster_valid=cl_mask[..., 0].any(dim=1), cluster_unit_meta=meta)


def _pad_rows(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    if not pad:
        return x
    tail = torch.full((pad,) + x.shape[1:], value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def _bake_compressed(scene: DeviceScene, rot, trn, scl) -> DeviceScene:
    """Bake instances of a compressed scene: grid records transform
    analytically (positions p -> s R p + t; corner-index rows copy), so
    direct tracing survives baking — nothing is ever pre-tessellated.

    Unit AABBs use the conservative |R| slab transform of the object
    AABBs (exact geometry lives in the records; AABBs only cull). Zero
    padding lanes transform to t, which is safe: padded leaf columns
    derive three EQUAL corners -> det == 0 -> rejected."""
    m = rot.shape[0]
    grid = scene.unit_grid                         # (U, R, GL)
    n_u, _, lanes = grid.shape
    pos = grid[None, :, 0:3, :]                    # (1, U, 3, GL)
    posw = torch.stack(
        [rot[:, i, 0, None, None] * pos[:, :, 0]
         + rot[:, i, 1, None, None] * pos[:, :, 1]
         + rot[:, i, 2, None, None] * pos[:, :, 2] for i in range(3)],
        dim=2)                                     # (M, U, 3, GL)
    posw = posw * scl[:, None, None, None] + trn[:, None, :, None]
    rest = grid[None, :, 3:, :].expand(m, -1, -1, -1)
    gridw = torch.cat([posw.reshape(m * n_u, 3, lanes),
                       rest.reshape(m * n_u, -1, lanes)], dim=1)

    def slab(lo, hi, valid):
        """Conservative world AABBs: c_w = s R c + t, h_w = s |R| h."""
        c_o = 0.5 * (lo + hi)
        h_o = 0.5 * (hi - lo)
        r = rot[:, None]
        c_w = _rot(r, c_o[None]) * scl[:, None, None] + trn[:, None, :]
        h_w = _rot(r.abs(), torch.where(valid[:, None], h_o, 0.0)[None]
                   ) * scl[:, None, None]
        mask = valid[None, :, None]
        return (torch.where(mask, c_w - h_w, BIG).reshape(-1, 3),
                torch.where(mask, c_w + h_w, -BIG).reshape(-1, 3))

    umin, umax = slab(scene.unit_aabb_min, scene.unit_aabb_max,
                      scene.unit_valid)
    unit_valid = scene.unit_valid.repeat(m)

    # Morton reorder (device twin of the host pack) + clusters.
    order = _morton_leaf_order(0.5 * (umin + umax), unit_valid)
    pad = (-gridw.shape[0]) % UNITS_PER_CLUSTER
    gridw = _pad_rows(gridw[order], pad)
    umin = _pad_rows(umin[order], pad, BIG)
    umax = _pad_rows(umax[order], pad, -BIG)
    unit_valid = _pad_rows(unit_valid[order], pad, False)

    # Per-triangle AABBs (coarse culling only), same |R| transform.
    aabb_min, aabb_max = slab(scene.aabb_min, scene.aabb_max,
                              scene.tri_valid)
    return dataclasses.replace(
        scene, aabb_min=aabb_min, aabb_max=aabb_max,
        tri_valid=scene.tri_valid.repeat(m),
        unit_aabb_min=umin, unit_aabb_max=umax, unit_valid=unit_valid,
        unit_grid=gridw, **_cluster_tables(umin, umax, unit_valid))


def _pack_leaves(leaf_verts: torch.Tensor, leaf_mask: torch.Tensor,
                 npad: int) -> dict:
    """Traversal units of world-space leaves (L, 3, 3) / (L,) bool:
    Morton-packed blocks of 64 valid leaves with their recentered MT
    tables and clusters — the device twin of scene.pack_units. The slot
    count stays fixed: invalid leaves sort to the tail as invalid
    units/clusters. npad: lane width of unit_nrm_pad."""
    lpu = scene_mod.LPU
    dev = leaf_verts.device
    centers = _f32.div((leaf_verts[:, 0] + leaf_verts[:, 1])
                       + leaf_verts[:, 2], 3.0)
    order = _morton_leaf_order(centers, leaf_mask)
    n_leaf = leaf_verts.shape[0]
    pad_n = -(-n_leaf // (lpu * UNITS_PER_CLUSTER)) \
        * (lpu * UNITS_PER_CLUSTER) - n_leaf
    lm_sorted = _pad_rows(leaf_mask[order], pad_n, False)
    unit_leaf_idx = _pad_rows(
        torch.where(leaf_mask[order], order.to(torch.int32), -1), pad_n, -1)
    lv_sorted = torch.where(lm_sorted[:, None, None],
                            _pad_rows(leaf_verts[order], pad_n), 0.0)

    u_total = lv_sorted.shape[0] // lpu
    ulv = lv_sorted.reshape(u_total, lpu, 3, 3)
    ulm = lm_sorted.reshape(u_total, lpu)
    u_lv = ulv.reshape(u_total, -1, 3)
    u_lm = ulm.repeat_interleave(3, dim=1)[..., None]
    unit_valid = ulm.any(dim=1)
    unit_aabb_min = torch.where(u_lm, u_lv, BIG).amin(dim=1)
    unit_aabb_max = torch.where(u_lm, u_lv, -BIG).amax(dim=1)

    # Recentered u/v rows, absolute q16 (see scene.pack_units).
    lmf = ulm[..., None].to(torch.float32)
    v0, v1, v2 = ulv[:, :, 0], ulv[:, :, 1], ulv[:, :, 2]
    center = 0.5 * (unit_aabb_min + unit_aabb_max)
    v0c = (v0 - center[:, None, :]) * lmf
    e1 = (v1 - v0) * lmf
    e2 = (v2 - v0) * lmf
    cross = culling._cross
    nvec = cross(e1, e2)
    w1 = cross(e2, v0c)
    w2 = cross(v0c, e1)
    w1_abs = cross(e2, v0 * lmf)
    w2_abs = cross(v0 * lmf, e1)

    def rows(x):
        return x.transpose(1, 2)                   # (U, LPU, 3) -> (U, 3, LPU)

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
            + a[..., 2] * b[..., 2]

    unit_e2w2 = dot(e2, w2)
    unit_nrm = nvec / torch.clamp_min(
        torch.sqrt(dot(nvec, nvec)), 1e-20)[..., None]
    unit_qn = torch.zeros((u_total, 8, 4 * lpu + 128), dtype=torch.float32,
                          device=dev)
    unit_qn[:, 0:3, 0 * lpu:1 * lpu] = rows(-nvec)
    unit_qn[:, 0:3, 1 * lpu:2 * lpu] = rows(-w1)
    unit_qn[:, 3:6, 1 * lpu:2 * lpu] = rows(e2)
    unit_qn[:, 0:3, 2 * lpu:3 * lpu] = rows(-w2)
    unit_qn[:, 3:6, 2 * lpu:3 * lpu] = rows(-e1)
    unit_qn[:, 0:3, 4 * lpu:5 * lpu] = rows(unit_nrm)
    unit_qn[:, 3, 4 * lpu:5 * lpu] = unit_e2w2
    unit_nrm_pad = torch.zeros((u_total, 8, npad), dtype=torch.float32,
                               device=dev)
    unit_nrm_pad[:, 0:3, 0:lpu] = rows(unit_nrm)
    unit_q16 = torch.zeros((u_total, 16, 4 * lpu), dtype=torch.float32,
                           device=dev)
    unit_q16[:, 0:3, 0 * lpu:1 * lpu] = rows(-nvec)
    unit_q16[:, 0:3, 1 * lpu:2 * lpu] = rows(-w1_abs)
    unit_q16[:, 3:6, 1 * lpu:2 * lpu] = rows(e2)
    unit_q16[:, 0:3, 2 * lpu:3 * lpu] = rows(-w2_abs)
    unit_q16[:, 3:6, 2 * lpu:3 * lpu] = rows(-e1)
    unit_q16[:, 6:9, 3 * lpu:4 * lpu] = rows(nvec)
    unit_q16[:, 9, 3 * lpu:4 * lpu] = -dot(e2, w2_abs)
    return dict(
        unit_aabb_min=unit_aabb_min, unit_aabb_max=unit_aabb_max,
        unit_valid=unit_valid,
        unit_leaf_idx=unit_leaf_idx.reshape(u_total, lpu),
        unit_qn=unit_qn, unit_n=nvec, unit_e2w2=unit_e2w2,
        unit_nrm=unit_nrm, unit_nrm_pad=unit_nrm_pad, unit_q16=unit_q16,
        **_cluster_tables(unit_aabb_min, unit_aabb_max, unit_valid))


def _bake(scene: DeviceScene, rot, trn, scl) -> DeviceScene:
    m = rot.shape[0]

    def dirs(x):
        """Rotate directions: (T, ..., 3) -> (M, T, ..., 3)."""
        return _rot(rot.reshape((m,) + (1,) * (x.dim() - 1) + (3, 3)),
                    x[None])

    def pts(x):
        """Transform points: (T, ..., 3) -> (M*T, ..., 3)."""
        out = dirs(x) * scl.reshape((m,) + (1,) * x.dim())
        out = out + trn.reshape((m,) + (1,) * (x.dim() - 1) + (3,))
        return out.reshape((-1,) + x.shape[1:])

    def lengths(x):
        """Scale-only quantities: (T, ...) -> (M*T, ...)."""
        if x is None:
            return None
        out = x[None] * scl.reshape((m,) + (1,) * x.dim())
        return out.reshape((-1,) + x.shape[1:])

    def tile(x):
        return None if x is None else x.repeat((m,) + (1,) * (x.dim() - 1))

    leaf_verts = pts(scene.leaf_verts)                    # (M*T, NF, 3, 3)
    leaf_mask = tile(scene.leaf_mask)

    # Per-triangle AABBs from transformed leaf vertices.
    lv = leaf_verts.reshape(leaf_verts.shape[0], -1, 3)
    lm = leaf_mask.repeat_interleave(3, dim=1)[..., None]
    tri_valid = tile(scene.tri_valid)
    aabb_min = torch.where(tri_valid[:, None],
                           torch.where(lm, lv, BIG).amin(dim=1), BIG)
    aabb_max = torch.where(tri_valid[:, None],
                           torch.where(lm, lv, -BIG).amax(dim=1), -BIG)
    return dataclasses.replace(
        scene, aabb_min=aabb_min, aabb_max=aabb_max,
        plane_t=dirs(scene.plane_t).reshape(-1, 3),
        plane_b=dirs(scene.plane_b).reshape(-1, 3),
        plane_n=dirs(scene.plane_n).reshape(-1, 3),
        plane_o=pts(scene.plane_o),
        node_verts=lengths(scene.node_verts),
        node_minmax=lengths(scene.node_minmax),
        node_pass=tile(scene.node_pass),
        leaf_verts=leaf_verts, leaf_mask=leaf_mask, tri_valid=tri_valid,
        **_pack_leaves(leaf_verts.reshape(-1, 3, 3), leaf_mask.reshape(-1),
                       scene.unit_nrm_pad.shape[2]))


# ----------------------------------------------------------------------
# Two-level traversal.

class WorldFrame(NamedTuple):
    """One frame's world-space ray data, shared by every instance."""

    apex: torch.Tensor         # (3,)
    normals: torch.Tensor      # (tiles, 4, 3) tile frustum planes
    sub_normals: torch.Tensor  # (tiles, nsub, 4, 3)
    dirs: torch.Tensor         # (tiles, TILE, 3)
    s: torch.Tensor            # (tiles, TILE) dot(origin - apex, d)


def world_frame(inv_view_proj, cfg: RenderConfig, device) -> WorldFrame:
    """The frame's world-space rays and frusta (one tile_frusta launch on
    the card)."""
    width, height = cfg.width, cfg.height
    pw, ph = tiled.padded_size(width, height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    apex, normals, sub_normals, _ = prologue.tile_frusta(
        torch.as_tensor(inv_view_proj, dtype=torch.float32, device=device),
        width, height, pw, ph, cfg.sub_frusta, cfg.sub_rows)
    origins, dirs = raygen.generate_rays(inv_view_proj, width, height,
                                         pw, ph, device=device)

    def to_tiles(x):
        return (x.reshape(ty, culling.TILE_H, tx, culling.TILE_W, 3)
                .permute(0, 2, 1, 3, 4).reshape(tx * ty, TILE, 3))

    dirs = to_tiles(dirs)
    oa = to_tiles(origins) - apex
    s = (oa[..., 0] * dirs[..., 0] + oa[..., 1] * dirs[..., 1]
         + oa[..., 2] * dirs[..., 2])
    return WorldFrame(apex, normals, sub_normals, dirs, s)


def _tile_cap(cfg: RenderConfig, n_tiles: int) -> int:
    """Per-instance tile-row cap of the SERIAL path's compaction window
    (the merged launch sizes its one global pool via _row_budget). The cap
    only bounds one instance's gathered-tile window — no N-scaled buffer
    exists here. 32 is four times the JAX package's default
    tiles_per_block of 8, a knob the port does not have."""
    cap = cfg.instance_tile_cap or max(32, n_tiles // 8)
    return min(n_tiles, cap)


def _row_budget(cfg: RenderConfig, n_tiles: int, n_inst: int) -> int:
    """Total (instance, tile) rows of the merged launch — ONE shared pool
    filled by footprint. Default n_tiles + 4 * n_inst: every screen tile
    claimed once (instances that tile the screen without overlap) plus 4
    rows per instance for overlap and conservative AABB-corner tiles; it
    scales with N so that at small frames the pool still holds a few rows
    per instance. Overflow (summed footprint > budget) stays exact via the
    serial re-run backstop. cfg.instance_tile_cap (a PER-INSTANCE tile
    cap) maps to its aggregate row meaning, cap * N — the overflow tests
    force tiny pools through it."""
    rows = (cfg.instance_tile_cap * n_inst if cfg.instance_tile_cap
            else n_tiles + 4 * n_inst)
    return min(n_inst * n_tiles, rows)


def assign_rows(tile_sees: torch.Tensor, rows: int):
    """Global row assignment of the merged launch, instance-major.

    tile_sees (N, tiles) bool flags every (instance, tile) pair whose
    frustum sees the instance. The seen pairs, in flat instance-major
    order, take the first `rows` rows; the pool's tail is padding. An
    instance is fully covered iff the running sum of footprints through
    it fits the pool. Returns (row_inst (rows,), row_tile (rows,),
    row_valid (rows,) bool, n_seen (N,), overflow (N,) bool)."""
    n_inst, n_tiles = tile_sees.shape
    total = n_inst * n_tiles
    fidx = torch.arange(total, device=tile_sees.device)
    key = torch.where(tile_sees.reshape(total), fidx, total)
    sel = torch.sort(key).values[:rows]
    row_valid = sel < total
    row_inst = torch.where(row_valid, sel // n_tiles, 0)
    row_tile = torch.where(row_valid, sel % n_tiles, 0)
    n_seen = tile_sees.sum(dim=1)
    return (row_inst, row_tile, row_valid, n_seen,
            torch.cumsum(n_seen, dim=0) > rows)


class MergedLaunch(NamedTuple):
    """Inputs of the merged raw launch and the rows' bookkeeping."""

    ccand: torch.Tensor      # (rows, kc) int32
    ccount: torch.Tensor     # (rows,) int32
    centry: torch.Tensor     # (rows, kc) f32
    frus: torch.Tensor       # (rows, pack) f32
    raymat: torch.Tensor | None   # (rows, 8, TILE), cfg.kernel_raygen False
    row_inst: torch.Tensor   # (rows,)
    row_tile: torch.Tensor   # (rows,)
    row_valid: torch.Tensor  # (rows,) bool
    n_seen: torch.Tensor     # (N,) tiles that see each instance
    overflow: torch.Tensor   # (N,) bool: not fully covered by the pool


def instance_cull(scene: DeviceScene, rot, trn, scl, world: WorldFrame):
    """Per-instance object-space camera + coarse cull, the only O(N x
    tiles) stage of the merged path: one cluster_select launch over the
    (instance, tile) rows that keeps only whether each row sees a cluster
    (no (N, tiles, C) mask). Returns (inv_s (N,), apex_o (N, 3), normals_o
    (N, tiles, 4, 3), tile_sees (N, tiles) bool)."""
    inv_s = _f32.rdiv(1.0, scl)
    apex_o = _rot_t(rot, world.apex - trn) * inv_s[:, None]
    normals_o = _rot_t(rot[:, None, None], world.normals[None])
    n_inst, n_tiles = normals_o.shape[:2]
    tile_sees = prologue.cluster_select(
        apex_o, normals_o.reshape(-1, 4, 3), scene.cluster_aabb_min,
        scene.cluster_aabb_max, scene.cluster_valid, 0,
        rows_per_apex=n_tiles, want_any=True).any
    return inv_s, apex_o, normals_o, tile_sees.reshape(n_inst, n_tiles)


def merged_launch_inputs(scene: DeviceScene, rot, trn, scl, ivp,
                         world: WorldFrame, cfg: RenderConfig
                         ) -> MergedLaunch:
    """The merged launch's prologue: the per-instance cull
    (instance_cull), the row assignment, and per ROW the frustum pack (or
    object-space ray matrix) and cluster list."""
    n_inst = rot.shape[0]
    pw, ph = tiled.padded_size(cfg.width, cfg.height)
    tx, ty = pw // culling.TILE_W, ph // culling.TILE_H
    n_tiles = tx * ty
    kc = tile_trace.clusters_per_window(scene, cfg)
    rows = _row_budget(cfg, n_tiles, n_inst)
    exit_aabb = tiled.scene_exit_aabb(scene)

    inv_s, apex_o, normals_o, tile_sees = instance_cull(scene, rot, trn,
                                                        scl, world)
    row_inst, row_tile, row_valid, n_seen, overflow = assign_rows(
        tile_sees, rows)

    row_rot = rot[row_inst]                               # (rows, 3, 3)
    row_apex = apex_o[row_inst]                           # (rows, 3)
    row_invs = inv_s[row_inst]
    sub_o = _rot_t(row_rot[:, None, None], world.sub_normals[row_tile])
    nsub = sub_o.shape[1]
    dev = rot.device
    parts = [row_apex, sub_o.reshape(rows, nsub * 12)]
    if cfg.kernel_raygen:
        # In-kernel raygen + object transform: the pack gains the raygen
        # scalars and [R^T (9), inv_s (1), apex_w (3)]; no (rows, TILE, 8)
        # ray table exists.
        raymat = None
        pack = tiled.frustum_pack_len(nsub, with_xform=True)
        px0 = ((row_tile % tx) * culling.TILE_W).to(torch.float32)
        py0 = ((row_tile // tx) * culling.TILE_H).to(torch.float32)
        m16 = torch.as_tensor(ivp, dtype=torch.float32, device=dev
                              ).reshape(16).expand(rows, 16)
        parts += [px0[:, None], py0[:, None], m16, exit_aabb.expand(rows, 6),
                  row_rot.transpose(1, 2).reshape(rows, 9),
                  row_invs[:, None], world.apex.expand(rows, 3)]
    else:
        d_o = _rot_t(row_rot[:, None], world.dirs[row_tile])
        m_o = culling._cross(row_apex[:, None, :].expand_as(d_o), d_o)
        s_o = world.s[row_tile] * row_invs[:, None]
        raymat = torch.cat(
            [d_o, m_o, s_o[..., None], torch.ones_like(s_o)[..., None]],
            dim=-1).transpose(1, 2).contiguous()
        pack = tiled.frustum_pack_len(nsub)
        parts.append(exit_aabb.expand(rows, 6))
    used = sum(p.shape[1] for p in parts)
    parts.append(torch.zeros((rows, pack - used), dtype=torch.float32,
                             device=dev))
    frus = torch.cat(parts, dim=1).contiguous()

    # Per-row front-to-back cluster lists, in top_k's (distance, index)
    # order (never torch.topk): one cluster_select launch that culls each
    # row again against its instance's object-space planes, as
    # instance_cull culled it.
    sel = prologue.cluster_select(
        row_apex, normals_o[row_inst, row_tile], scene.cluster_aabb_min,
        scene.cluster_aabb_max, scene.cluster_valid, kc,
        row_valid=row_valid)
    return MergedLaunch(sel.ccand, sel.ccount, sel.centry, frus, raymat,
                        row_inst, row_tile, row_valid, n_seen, overflow)


def combine_rows(out: torch.Tensor, launch: MergedLaunch, rot, scl,
                 n_tiles: int):
    """Object -> world (t scales per instance, normals rotate), then the
    min-combine across instances by target tile. Exact-tie normals sum,
    matching the kernel's own tie semantics; index_add_ adds with atomics
    on the card, so the sum's order matters only where two instances hit
    one pixel at exactly the same world t. Returns (best_t (tiles, TILE),
    best_n (tiles, TILE, 3))."""
    row_inst, row_tile = launch.row_inst, launch.row_tile
    bt_o = out[:, 0]                                      # (rows, TILE)
    bn_o = out[:, 1:4].transpose(1, 2)                    # (rows, TILE, 3)
    bt_w = torch.where(bt_o < BIG * 0.5, bt_o * scl[row_inst][:, None], BIG)
    bn_w = _rot(rot[row_inst][:, None], bn_o)
    best_t = torch.full((n_tiles, TILE), BIG, dtype=torch.float32,
                        device=out.device)
    best_t.scatter_reduce_(0, row_tile[:, None].expand(-1, TILE), bt_w,
                           "amin")
    winner = bt_w <= best_t[row_tile]
    best_n = torch.zeros((n_tiles, TILE, 3), dtype=torch.float32,
                         device=out.device)
    best_n.index_add_(0, row_tile, torch.where(winner[..., None], bn_w, 0.0))
    return best_t, best_n


def shade_frame(best_t, best_n, world: WorldFrame, cfg: RenderConfig):
    """(H, W, 3) frame of the combined world-space hits: the summed winner
    normal normalised and shaded against -d, misses the background."""
    hit = best_t < BIG * 0.5
    nn = torch.sqrt(best_n[..., 0] * best_n[..., 0]
                    + best_n[..., 1] * best_n[..., 1]
                    + best_n[..., 2] * best_n[..., 2])
    nrm = best_n / torch.clamp_min(nn, 1e-20)[..., None]
    colors = shading.shade_or_miss(hit, nrm, -world.dirs, cfg)
    return tile_trace._to_image(colors, cfg)


def _render_instanced_merged(scene: DeviceScene, rot, trn, scl, ivp,
                             cfg: RenderConfig) -> torch.Tensor:
    """N-insensitive two-level traversal: ONE kernel launch for ALL
    instances.

    Every kernel input is per tile row (the frustum pack carries the apex;
    t_num derives in-kernel), so instances batch exactly like frames
    (tile_trace.render_frames). Rows come from ONE global pool
    (_row_budget, assign_rows). Closest hits min-combine across instances
    in world t afterwards (combine_rows). Cost scales with the summed
    screen FOOTPRINT, not with N — the role hardware TLAS instancing plays
    for the reference (src/GPUMesh.cpp:238-278).

    Exactness is preserved by a follow-up pass: if the summed footprint
    overflows the pool, every instance at or past the truncation point
    re-runs through the serial full-frame trace, min-combining into the
    same best. The overflow flags are fetched once per frame (one host
    sync), so the common all-fit case stays one launch. Requires
    single-window cluster lists (num_clusters <=
    kernel_clusters_per_window)."""
    world = world_frame(ivp, cfg, scene.device)
    launch = merged_launch_inputs(scene, rot, trn, scl, ivp, world, cfg)
    meta, tables, opts = tile_trace.scene_tables(scene)
    out, _, _ = tile_trace.trace_raw(
        launch.ccand, launch.ccount, launch.centry, launch.frus, meta,
        tables, cfg, raymat=launch.raymat, **opts)
    best_t, best_n = combine_rows(out, launch, rot, scl,
                                  world.dirs.shape[0])
    best_t, best_n = _overflow_pass(scene, rot, trn, scl, launch.overflow,
                                    best_t, best_n, world, cfg)
    return shade_frame(best_t, best_n, world, cfg)


class _ObjectCamera(NamedTuple):
    """One instance's camera in its object space."""

    apex: torch.Tensor         # (3,)
    normals: torch.Tensor      # (tiles, 4, 3)
    sub_normals: torch.Tensor  # (tiles, nsub, 4, 3)
    cluster_hit: torch.Tensor  # (tiles, C) bool
    inv_s: torch.Tensor        # ()


def _object_camera(scene, r, t, s, world: WorldFrame) -> _ObjectCamera:
    """p_obj = R^T (p - t) / s; directions rotate only."""
    inv_s = _f32.rdiv(1.0, s)
    apex_o = _rot_t(r, world.apex - t) * inv_s
    normals_o = _rot_t(r, world.normals)
    hit = prologue.cluster_select(
        apex_o[None], normals_o, scene.cluster_aabb_min,
        scene.cluster_aabb_max, scene.cluster_valid, 0,
        rows_per_apex=normals_o.shape[0], want_hit=True).hit
    return _ObjectCamera(apex_o, normals_o, _rot_t(r, world.sub_normals),
                         hit, inv_s)


def _trace_instance(scene, cam: _ObjectCamera, r, s, best_t, best_n,
                    world: WorldFrame, cfg: RenderConfig, tidx=None):
    """One instance through the windowed kernel, over every tile or the
    gathered tiles tidx. The world-space carry converts to object space (t
    scales, normals rotate) so the walk's early exit prunes against hits
    of earlier instances. Returns the world-space (t, normals (m, TILE,
    3), t carried in) of those tiles."""
    sel = slice(None) if tidx is None else tidx
    dirs_o = _rot_t(r, world.dirs[sel])
    m_o = culling._cross(cam.apex.expand_as(dirs_o), dirs_o)
    s_o = world.s[sel] * cam.inv_s
    raymat = torch.cat([dirs_o, m_o, s_o[..., None],
                        torch.ones_like(s_o)[..., None]], dim=-1)
    fi = tiled.FrameInputs(raymat, dirs_o, cam.apex, cam.normals[sel],
                           cam.cluster_hit[sel], cam.sub_normals[sel],
                           tiled.scene_exit_aabb(scene))
    frus = tiled.frustum_scalars(fi)
    raymat_t = raymat.transpose(1, 2).contiguous()
    meta, tables, opts = tile_trace.scene_tables(scene)

    def trace_window(ccand, ccount, centry, bt, rest):
        bt, *rest = tile_trace.trace_windowed(
            ccand, ccount, centry, frus, raymat_t, (bt, *rest), meta,
            tables, cfg, **opts)
        return bt, tuple(rest)

    old_t = best_t[sel]
    counts = torch.zeros(old_t.shape[0], dtype=torch.int32,
                         device=old_t.device)
    init_n = _rot_t(r, best_n[sel]).transpose(1, 2).contiguous()
    bt_o, (bn_rows, _, _), _ = tiled.trace_windowed_clusters(
        scene, fi, trace_window, old_t * cam.inv_s, (init_n, counts, counts),
        tile_trace.clusters_per_window(scene, cfg))
    bn_w = _rot(r, bn_rows.transpose(1, 2))
    return torch.where(bt_o < BIG * 0.5, bt_o * s, old_t), bn_w, old_t


def _overflow_pass(scene, rot, trn, scl, overflow, best_t, best_n,
                   world: WorldFrame, cfg: RenderConfig):
    """Serial full-frame pass over ONLY the instances whose footprint
    overflowed the merged launch's row pool (min-combining is idempotent
    for rows already traced). `overflow` comes to the host once."""
    # nonzero() itself waits for the device: it is the sync's read.
    for i in spans.sync("instances.overflow", overflow,
                        lambda m: m.nonzero()[:, 0].tolist()):
        cam = _object_camera(scene, rot[i], trn[i], scl[i], world)
        best_t, best_n, _ = _trace_instance(scene, cam, rot[i], scl[i],
                                            best_t, best_n, world, cfg)
    return best_t, best_n


def _render_instanced(scene: DeviceScene, rot, trn, scl, ivp,
                      cfg: RenderConfig, serial: bool = False):
    # The merged one-launch path is the production TLAS analog whenever a
    # single cluster window covers the scene; serial=True forces the
    # per-instance scan — its A/B partner and independent reference.
    if (scene.num_clusters <= max(1, cfg.kernel_clusters_per_window)
            and not serial):
        return _render_instanced_merged(scene, rot, trn, scl, ivp, cfg)
    world = world_frame(ivp, cfg, scene.device)
    n_tiles = world.dirs.shape[0]
    dev = scene.device
    m_cap = _tile_cap(cfg, n_tiles)
    tile_ids = torch.arange(n_tiles, device=dev)
    best_t = torch.full((n_tiles, TILE), BIG, dtype=torch.float32,
                        device=dev)
    best_n = torch.zeros((n_tiles, TILE, 3), dtype=torch.float32,
                         device=dev)
    for i in range(rot.shape[0]):
        cam = _object_camera(scene, rot[i], trn[i], scl[i], world)
        tile_sees = cam.cluster_hit.any(dim=1)
        # One host sync per instance: right, and slow.
        if m_cap < n_tiles and spans.sync("instances.tile_cap",
                                          tile_sees.sum()) <= m_cap:
            # Per-tile instance culling: gather only the tiles whose
            # frustum sees this instance (ascending, then unseen tiles as
            # padding: their cluster lists are empty and pass the carry
            # through), trace those, scatter the improved hits back.
            # Per-instance cost is O(screen footprint), not O(frame).
            tidx = torch.argsort(torch.where(tile_sees, tile_ids,
                                             tile_ids + n_tiles))[:m_cap]
            bt_w, bn_w, old_t = _trace_instance(
                scene, cam, rot[i], scl[i], best_t, best_n, world, cfg, tidx)
            improved = bt_w < old_t
            best_t[tidx] = torch.where(improved, bt_w, old_t)
            best_n[tidx] = torch.where(improved[..., None], bn_w,
                                       best_n[tidx])
        else:
            # All tiles (an instance filling most of the frame).
            best_t, best_n, _ = _trace_instance(
                scene, cam, rot[i], scl[i], best_t, best_n, world, cfg)
    return shade_frame(best_t, best_n, world, cfg)


def render_instanced(scene: DeviceScene, instances, inv_view_proj,
                     cfg: RenderConfig, serial: bool = False):
    """Render N instances of `scene` with true two-level traversal, on
    the scene's device.

    Returns (H, W, 3) float32. The scene tables are shared (object space,
    precomputed or compressed); only a (N, 3, 3) rotation + (N, 3)
    translation + (N,) scale stack is instance-specific. instances: a
    list of Instance, or (rot, trn, scl) arrays. serial=True forces the
    per-instance scan."""
    rot, trn, scl = instance_tensors(instances, scene.device)
    return _render_instanced(scene, rot, trn, scl, inv_view_proj, cfg,
                             serial)


class InstancedRenderer:
    """Two-level (TLAS-style) frame renderer: N instances of one shared
    object-space scene, O(scene + N) device memory."""

    def __init__(self, scene: DeviceScene, instances, cfg: RenderConfig):
        self.scene = scene
        self.cfg = cfg
        self.rot, self.trn, self.scl = instance_tensors(instances,
                                                        scene.device)

    def render(self, inv_view_proj) -> torch.Tensor:
        return _render_instanced(self.scene, self.rot, self.trn, self.scl,
                                 inv_view_proj, self.cfg)

    def render_u8_device(self, inv_view_proj) -> torch.Tensor:
        """(H, W, 3) uint8 frame, quantized on the scene's device (the
        form FramePipeline queues)."""
        return _quantize(self.render(inv_view_proj))

    def render_u8(self, inv_view_proj) -> np.ndarray:
        return self.render_u8_device(inv_view_proj).cpu().numpy()
