"""Device scene: padded dense tensors for the tile renderer.

This replaces the reference's GPU scene build (src/GPUMesh.cpp:32-110 — buffer
uploads, AABB compute pass, BLAS/TLAS build) and its six t1-t5 SRV tables
(src/application.cpp:124-161). The tables are built in NumPy on the host,
exactly as the JAX package builds them, and end up as one frozen dataclass
of named tensors on the render device.

The acceleration structure analog: traversal units are Morton-packed blocks
of 64 valid leaf micro-triangles with precomputed Möller-Trumbore tables;
clusters are 64 consecutive units with an AABB and a per-unit metadata
block — the TLAS role the trace kernel walks front to back.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping

import numpy as np
import torch

from ..ops import compressed as comp
from ..ops import precompute, subdivision
from ..ops.culling import UNITS_PER_CLUSTER
from ..ops.intersect import MT_UV_EPS
from . import mesh as mesh_mod

BIG = np.float32(1e30)

# Static (non-tensor) fields; everything else is a tensor or None.
META_FIELDS = ("max_level", "compressed", "sub_level", "indexed")


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """All tensors are padded to T triangles; NI = (4^L-1)/3, NF = 4^L.

    Micro-mesh mode: node_* hold the delta-expanded displaced 2D hierarchy
    (levels 0..L-1, level-ordered, slot = 4*parent + digit) and leaf_verts the
    displaced 3D micro-triangles placed at slot k << 2*(L - level_t).
    Tessellated mode (`-T`): node_pass is all-True (NI=1) and leaf_verts holds
    the uFaces expansion — same renderer, no hierarchy pruning.

    Field names, shapes and contents are those of the JAX package's
    DeviceScene (rtmm_tpu/models/scene.py), so a scene saved by either
    package loads into the other unchanged (scene_from_arrays).
    """

    aabb_min: torch.Tensor    # (T, 3)
    aabb_max: torch.Tensor    # (T, 3)
    plane_t: torch.Tensor     # (T, 3)
    plane_b: torch.Tensor     # (T, 3)
    plane_n: torch.Tensor     # (T, 3)
    plane_o: torch.Tensor     # (T, 3)
    # Hierarchy tables — read only by the per-ray reference backend
    # (ops/traversal.py) and the step heatmap; None when built with
    # hierarchy=False.
    node_verts: torch.Tensor | None   # (T, NI, 3, 2)
    node_minmax: torch.Tensor | None  # (T, NI, 2)
    node_pass: torch.Tensor | None    # (T, NI) bool
    leaf_verts: torch.Tensor  # (T, NF, 3, 3)
    leaf_mask: torch.Tensor   # (T, NF) bool
    tri_valid: torch.Tensor   # (T,) bool
    # Traversal units: blocks of LPU valid leaves packed in Morton order;
    # unit_leaf_idx maps each unit slot back into the flat (T*NF) leaf
    # table, -1 for padding.
    unit_aabb_min: torch.Tensor  # (U, 3)
    unit_aabb_max: torch.Tensor  # (U, 3)
    unit_valid: torch.Tensor     # (U,) bool
    unit_leaf_idx: torch.Tensor  # (U, LPU) int32
    # Möller-Trumbore tables with a shared ray apex `a`, RECENTERED about
    # the unit AABB center c = 0.5*(unit_aabb_min + unit_aabb_max):
    #   det   = [d, m] . [-n, 0]
    #   u_num = [d, m] . [-w1, e2]         (w1 = e2 x (v0 - c), n = e1 x e2)
    #   v_num = [d, m] . [-w2, -e1]        (w2 = (v0 - c) x e1)
    #   t_num = (a - c).n - e2.w2          (ray-independent)
    # with the per-unit moment m = (a - c) x d. Absent leaves are zero
    # rows (det == 0 -> rejected by the acceptance window).
    unit_qn: torch.Tensor        # (U, 8, 4*LPU + 128) [det|u|v|t_num|nrm rows]
    unit_n: torch.Tensor         # (U, LPU, 3) unnormalized e1 x e2
    unit_e2w2: torch.Tensor      # (U, LPU)
    unit_nrm: torch.Tensor       # (U, LPU, 3) normalized shading normals
    unit_nrm_pad: torch.Tensor   # (U, 8, >=128) padded normal table
    unit_q16: torch.Tensor       # (U, 16, 4*LPU) arbitrary-origin MT table
    # Compressed mode only: per-unit displaced grid-vertex records
    # (ops/compressed.py), (U, GRID_ROWS | IDX_ROWS, GRID_LANES) f32. A
    # compressed scene holds only these, the AABBs and the cluster tables
    # (every precomputed table above is None): the trace kernel derives
    # each visited unit's tables from its record.
    unit_grid: torch.Tensor | None
    # Scene-level hierarchy over units (the TLAS role): cluster c covers the
    # Morton-consecutive units [c*UNITS_PER_CLUSTER, (c+1)*UNITS_PER_CLUSTER).
    cluster_aabb_min: torch.Tensor  # (C, 3)
    cluster_aabb_max: torch.Tensor  # (C, 3)
    cluster_valid: torch.Tensor     # (C,) bool
    # Per-cluster unit metadata for the kernel's in-kernel unit cull:
    # rows 0-2 unit AABB min xyz, 3-5 max xyz, 6 valid (0/1), lanes
    # 0..UNITS_PER_CLUSTER-1.
    cluster_unit_meta: torch.Tensor  # (C, 8, 128) f32
    max_level: int
    compressed: bool = False   # unit_grid-only scene (see above)
    sub_level: int = 0         # grid sub-level of a unit (compressed)
    # Compressed records carry per-unit leaf-corner lane indices (rows
    # 3-5, ops/compressed.py IDX_ROWS): mixed-level / stitched meshes and
    # level < 3 meshes packed several triangles per unit.
    indexed: bool = False
    # Shared gather matrix (GRID_LANES, 3*LPU) of an indexed scene whose
    # units all share one topology; None when topologies differ.
    unit_gmat: torch.Tensor | None = None

    @property
    def num_triangles(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def num_leaf_slots(self) -> int:
        return self.leaf_verts.shape[1]

    @property
    def leaves_per_unit(self) -> int:
        if self.unit_qn is None:
            return LPU
        return (self.unit_qn.shape[2] - 128) // 4

    @property
    def num_units(self) -> int:
        return self.unit_aabb_min.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.cluster_aabb_min.shape[0]

    @property
    def device(self) -> torch.device:
        return self.unit_aabb_min.device

    @functools.cached_property
    def exit_aabb(self) -> torch.Tensor:
        """(6,) f32 [min xyz, max xyz]: the union of valid cluster AABBs,
        inflated so that every hit the MT epilogue can ACCEPT (uv within
        MT_UV_EPS outside a leaf, i.e. up to ~eps * extent outside the
        exact geometry AABB) still lies inside. A ray's slab EXIT through
        this box upper-bounds the apex-relative t of any hit it may still
        find. It reads only the scene's cluster boxes, so it is computed
        once per scene, on first use (ops/tiled.scene_exit_aabb)."""
        valid = self.cluster_valid[:, None]
        mn = torch.where(valid, self.cluster_aabb_min, 1e30).amin(dim=0)
        mx = torch.where(valid, self.cluster_aabb_max, -1e30).amax(dim=0)
        pad = 2.0 * MT_UV_EPS * (mx - mn) + 1e-6
        return torch.cat([mn - pad, mx + pad]).to(torch.float32)

    def device_bytes(self) -> int:
        """Bytes of every tensor the scene holds on its device."""
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, f.name)
                             for f in dataclasses.fields(self))
                   if isinstance(t, torch.Tensor))


def _to_device(x, device):
    if x is None:
        return None
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:      # e.g. a JAX array's host view
        x = x.copy()
    return torch.from_numpy(x).to(device)


def scene_from_arrays(arrays: Mapping[str, np.ndarray], *,
                      device="cuda") -> DeviceScene:
    """Build the port's scene from the arrays the JAX package saves.

    `arrays` holds the keys rtmm_tpu.utils.cache.save_scene writes (an
    opened .npz works): the meta fields max_level / compressed / sub_level
    / indexed, plus every field that is not None. A missing field is None.
    So a scene the JAX package built runs through the port on the very
    same tables, compressed records (unit_grid, unit_gmat) included.
    """
    keys = set(arrays.keys())
    tensors = {f.name: (_to_device(np.asarray(arrays[f.name]), device)
                        if f.name in keys else None)
               for f in dataclasses.fields(DeviceScene)
               if f.name not in META_FIELDS}
    return DeviceScene(
        max_level=int(np.asarray(arrays["max_level"])),
        compressed=bool(np.asarray(arrays["compressed"])),
        sub_level=int(np.asarray(arrays["sub_level"])),
        indexed=(bool(np.asarray(arrays["indexed"]))
                 if "indexed" in keys else False),
        **tensors)


def scene_arrays(scene: DeviceScene) -> dict[str, np.ndarray]:
    """The scene as host arrays, scene_from_arrays' input: every tensor
    that is not None, and the meta fields."""
    arrays = {f.name: getattr(scene, f.name).cpu().numpy()
              for f in dataclasses.fields(scene)
              if f.name not in META_FIELDS
              and getattr(scene, f.name) is not None}
    arrays.update({name: np.asarray(getattr(scene, name))
                   for name in META_FIELDS})
    return arrays


def build_device_scene(mesh: mesh_mod.MicroMesh, tessellated: bool = False,
                       pad_triangles_to: int = 8,
                       hierarchy: bool = False,
                       compressed: bool = False,
                       device="cuda") -> DeviceScene:
    """Run all host precompute and pack the padded device tensors.

    Mirrors GPUMesh::loadGLTFMeshGPU + the Application scene-build block
    (src/application.cpp:113-197) in one call. The NumPy build is the JAX
    package's, line for line; only the final upload differs
    (torch.from_numpy(...).to(device) instead of jax.device_put).

    Uniform-level all-present meshes (every real asset baked at one level)
    take a batched NumPy path vectorized over triangles; mixed levels /
    stitched presence batch by (level, presence-pattern) group.

    hierarchy=False (the default here) skips the per-node delta/min-max
    tables (node_verts/node_minmax/node_pass come back None): only the
    per-ray reference backend (pipeline "ray", the path tracer's perray
    engine, utils/stats.traversal_heatmap) reads them, so the kernel
    paths skip building and uploading them.

    compressed=True builds the direct-tracing scene (ops/compressed.py):
    only per-unit grid-vertex records go to the device (~32 B per
    micro-triangle against ~580 B for the precomputed tables), and the
    trace kernel derives each visited unit's tables.
    """
    if compressed:
        if tessellated:
            raise ValueError("compressed mode traces the micro-mesh "
                             "directly; tessellated (-T) mode precomputes "
                             "triangles by definition")
        return build_compressed_scene(mesh, device=device)
    t_real = mesh.num_triangles
    uniform = (mesh.has_uniform_subdivision_level()
               and mesh.all_present())
    groups = None
    if not uniform:
        groups = {}
        for i, t in enumerate(mesh.triangles):
            key = (t.subdivision_level, t.u_present.tobytes())
            groups.setdefault(key, []).append(i)
    t_pad = max(_round_up(t_real, pad_triangles_to), pad_triangles_to)
    max_level = mesh.max_level

    if tessellated:
        if uniform:
            nf = max(4**max_level, 1)
        else:
            nf = max(max(mesh.triangles[ids[0]].u_faces.shape[0]
                         for ids in groups.values()), 1)
        ni = 1
    else:
        ni = max(subdivision.num_internal_nodes(max_level), 1)
        nf = 4**max_level
    nf = max(nf, 1)

    aabb_min = np.full((t_pad, 3), BIG, np.float32)
    aabb_max = np.full((t_pad, 3), -BIG, np.float32)
    plane = {k: np.zeros((t_pad, 3), np.float32)
             for k in ("t", "b", "n", "o")}
    plane["n"][:, 2] = 1.0  # benign default frame for padding
    plane["t"][:, 0] = 1.0
    plane["b"][:, 1] = 1.0
    if hierarchy:
        node_verts = np.zeros((t_pad, ni, 3, 2), np.float32)
        node_minmax = np.tile(np.asarray([[-BIG, BIG]], np.float32),
                              (t_pad * ni, 1)).reshape(t_pad, ni, 2)
        node_pass = np.ones((t_pad, ni), bool)
    else:
        node_verts = node_minmax = node_pass = None
    leaf_verts = np.zeros((t_pad, nf, 3, 3), np.float32)
    leaf_mask = np.zeros((t_pad, nf), bool)
    tri_valid = np.zeros((t_pad,), bool)

    if uniform:
        # Batched fill, chunked over triangles to bound peak memory.
        chunk = max(1, 2_000_000 // max(4**max_level, 1))
        for s in range(0, t_real, chunk):
            e = min(s + chunk, t_real)
            bt = precompute.build_uniform_tables(mesh, s, e)
            aabb_min[s:e] = bt["aabb_min"]
            aabb_max[s:e] = bt["aabb_max"]
            plane["t"][s:e] = bt["plane_t"]
            plane["b"][s:e] = bt["plane_b"]
            plane["n"][s:e] = bt["plane_n"]
            plane["o"][s:e] = bt["plane_o"]
            tri_valid[s:e] = True
            f = bt["tess_verts"].shape[1]
            if tessellated:
                leaf_verts[s:e, :f] = bt["tess_verts"]
                leaf_mask[s:e, :f] = True
            else:
                ni_t = bt["node_verts"].shape[1]
                if ni_t and hierarchy:
                    node_verts[s:e, :ni_t] = bt["node_verts"]
                    node_minmax[s:e, :ni_t] = bt["node_minmax"]
                    node_pass[s:e, :ni_t] = False
                leaf_verts[s:e, :f] = bt["leaf_verts"]
                leaf_mask[s:e, :f] = True
    else:
        for (lvl_g, _), ids in groups.items():
            chunk = max(1, 2_000_000 // max(4**lvl_g, 1))
            for s in range(0, len(ids), chunk):
                sel = np.asarray(ids[s:s + chunk], np.int64)
                bt = precompute.build_group_tables(mesh, sel)
                aabb_min[sel] = bt["aabb_min"]
                aabb_max[sel] = bt["aabb_max"]
                plane["t"][sel] = bt["plane_t"]
                plane["b"][sel] = bt["plane_b"]
                plane["n"][sel] = bt["plane_n"]
                plane["o"][sel] = bt["plane_o"]
                tri_valid[sel] = True
                if tessellated:
                    f = bt["tess_verts"].shape[1]
                    leaf_verts[sel, :f] = bt["tess_verts"]
                    leaf_mask[sel, :f] = True
                    continue
                ni_t = bt["node_verts"].shape[1]
                if ni_t and hierarchy:
                    node_verts[sel, :ni_t] = bt["node_verts"]
                    node_minmax[sel, :ni_t] = bt["node_minmax"]
                    node_pass[sel, :ni_t] = False  # real nodes: test them
                # Leaves: slot k (level lvl_g) -> flat k << 2*(L - lvl_g).
                flat = bt["leaf_slots"] * 4 ** (max_level - lvl_g)
                leaf_verts[sel[:, None], flat[None, :]] = bt["leaf_verts"]
                leaf_mask[sel[:, None], flat[None, :]] = True

    units = pack_units(leaf_verts.reshape(-1, 3, 3), leaf_mask.reshape(-1))

    def dev(x):
        return _to_device(x, device)

    return DeviceScene(
        aabb_min=dev(aabb_min), aabb_max=dev(aabb_max),
        plane_t=dev(plane["t"]), plane_b=dev(plane["b"]),
        plane_n=dev(plane["n"]), plane_o=dev(plane["o"]),
        node_verts=dev(node_verts), node_minmax=dev(node_minmax),
        node_pass=dev(node_pass), leaf_verts=dev(leaf_verts),
        leaf_mask=dev(leaf_mask), tri_valid=dev(tri_valid),
        **{k: dev(v) for k, v in units.items()},
        max_level=0 if tessellated else max_level)


LPU = 64  # leaf micro-triangles per traversal unit


def pack_units(leaf_verts_flat: np.ndarray, leaf_mask_flat: np.ndarray
               ) -> dict:
    """Build the traversal-unit + cluster tables from a flat leaf table.

    Units are blocks of LPU *valid* leaves packed along a Morton curve of
    the leaf centroids (leaves from different base triangles mix freely —
    the MT tables are per-leaf). Clusters (UNITS_PER_CLUSTER consecutive
    units — the TLAS analog, src/GPUMesh.cpp:238-278) are then spatially
    coherent.

    leaf_verts_flat: (L, 3, 3) float32; leaf_mask_flat: (L,) bool.
    Returns the unit_* / cluster_* DeviceScene fields (np arrays).
    """
    lpu = LPU
    idx = np.nonzero(leaf_mask_flat)[0].astype(np.int64)
    if idx.size:
        centers = leaf_verts_flat[idx].mean(axis=1)
        idx = idx[np.argsort(_morton_codes(centers), kind="stable")]
    n_leaves = idx.shape[0]
    per_cluster = lpu * UNITS_PER_CLUSTER
    l_pad = max(_round_up(n_leaves, per_cluster), per_cluster)

    unit_leaf_idx = np.full(l_pad, -1, np.int64)
    unit_leaf_idx[:n_leaves] = idx
    lvu = np.zeros((l_pad, 3, 3), np.float32)
    lvu[:n_leaves] = leaf_verts_flat[idx]
    u_total = l_pad // lpu
    lvu = lvu.reshape(u_total, lpu, 3, 3)
    lmu_b = (unit_leaf_idx >= 0).reshape(u_total, lpu)

    ulv = lvu.reshape(u_total, lpu * 3, 3)
    ulm = np.repeat(lmu_b, 3, axis=1)
    unit_valid = lmu_b.any(axis=1)
    big3 = np.broadcast_to(np.float32(BIG), ulv.shape)
    unit_aabb_min = np.where(ulm[..., None], ulv, big3).min(axis=1)
    unit_aabb_max = np.where(ulm[..., None], ulv, -big3).max(axis=1)

    # MT tables, RECENTERED about the unit AABB center c = 0.5*(min+max):
    # w1/w2 use v0 - c, and the trace-time ray moment becomes
    # (apex - c) x d. Möller-Trumbore is translation-invariant, so the
    # results are identical analytically, while every cancelling partial
    # product shrinks from scene magnitude to unit magnitude.
    lmu = lmu_b[..., None].astype(np.float32)
    v0, v1, v2 = lvu[:, :, 0], lvu[:, :, 1], lvu[:, :, 2]
    center = 0.5 * (unit_aabb_min + unit_aabb_max)        # (U, 3)
    v0c = (v0 - center[:, None, :]) * lmu
    e1 = (v1 - v0) * lmu
    e2 = (v2 - v0) * lmu
    nvec = np.cross(e1, e2)
    w1 = np.cross(e2, v0c)
    w2 = np.cross(v0c, e1)
    # The arbitrary-origin q16 table (secondary-bounce engines) keeps
    # ABSOLUTE coordinates.
    w1_abs = np.cross(e2, v0 * lmu)
    w2_abs = np.cross(v0 * lmu, e1)
    # unit_qn: (U, 8, 4*LPU + 128) — rows matching the ray rows
    # [dx,dy,dz, mx,my,mz, s, 1]; column blocks [det | u_num | v_num |
    # t_num], then a 128-lane normal block (rows 0..2 = normal xyz over the
    # first LPU lanes, row 3 = e2.w2) so one unit's MT table and shading
    # normals are one contiguous record.
    unit_qn = np.zeros((u_total, 8, 4 * lpu + 128), np.float32)
    unit_qn[:, 0:3, 0 * lpu:1 * lpu] = -nvec.transpose(0, 2, 1)
    unit_qn[:, 0:3, 1 * lpu:2 * lpu] = -w1.transpose(0, 2, 1)
    unit_qn[:, 3:6, 1 * lpu:2 * lpu] = e2.transpose(0, 2, 1)
    unit_qn[:, 0:3, 2 * lpu:3 * lpu] = -w2.transpose(0, 2, 1)
    unit_qn[:, 3:6, 2 * lpu:3 * lpu] = -e1.transpose(0, 2, 1)
    unit_e2w2 = (e2 * w2).sum(-1).astype(np.float32)
    e2w2_abs = (e2 * w2_abs).sum(-1).astype(np.float32)
    norm = np.maximum(np.linalg.norm(nvec, axis=-1, keepdims=True), 1e-20)
    unit_nrm = (nvec / norm).astype(np.float32)
    unit_qn[:, 0:3, 4 * lpu:4 * lpu + lpu] = unit_nrm.transpose(0, 2, 1)
    # Row 3 of the normal block carries e2.w2 so the kernel forms
    # t_num = (apex - c).n - e2.w2 itself: the table is camera-independent.
    unit_qn[:, 3, 4 * lpu:4 * lpu + lpu] = unit_e2w2
    unit_nrm_pad = np.zeros((u_total, 8, max(128, lpu)), np.float32)
    unit_nrm_pad[:, 0:3, 0:lpu] = unit_nrm.transpose(0, 2, 1)

    # Generalized MT table for arbitrary-origin rays (secondary bounces):
    # ray vector rows [d(3), o x d(3), o(3), 1, pad(6)].
    unit_q16 = np.zeros((u_total, 16, 4 * lpu), np.float32)
    unit_q16[:, 0:3, 0 * lpu:1 * lpu] = -nvec.transpose(0, 2, 1)
    unit_q16[:, 0:3, 1 * lpu:2 * lpu] = -w1_abs.transpose(0, 2, 1)
    unit_q16[:, 3:6, 1 * lpu:2 * lpu] = e2.transpose(0, 2, 1)
    unit_q16[:, 0:3, 2 * lpu:3 * lpu] = -w2_abs.transpose(0, 2, 1)
    unit_q16[:, 3:6, 2 * lpu:3 * lpu] = -e1.transpose(0, 2, 1)
    unit_q16[:, 6:9, 3 * lpu:4 * lpu] = nvec.transpose(0, 2, 1)
    unit_q16[:, 9, 3 * lpu:4 * lpu] = -e2w2_abs

    return dict(
        unit_aabb_min=unit_aabb_min, unit_aabb_max=unit_aabb_max,
        unit_valid=unit_valid,
        unit_leaf_idx=unit_leaf_idx.reshape(u_total, lpu).astype(np.int32),
        unit_qn=unit_qn, unit_n=nvec.astype(np.float32),
        unit_e2w2=unit_e2w2, unit_nrm=unit_nrm,
        unit_nrm_pad=unit_nrm_pad, unit_q16=unit_q16, unit_grid=None,
        **build_clusters(unit_aabb_min, unit_aabb_max, unit_valid))


def build_clusters(unit_aabb_min: np.ndarray, unit_aabb_max: np.ndarray,
                   unit_valid: np.ndarray) -> dict:
    """Cluster tables over (already Morton-ordered, 64-multiple) units:
    AABBs, validity, and the kernel's per-unit metadata block."""
    n_cl = unit_valid.shape[0] // UNITS_PER_CLUSTER
    cl_mask = unit_valid.reshape(n_cl, UNITS_PER_CLUSTER, 1)
    cluster_aabb_min = np.where(
        cl_mask, unit_aabb_min.reshape(n_cl, UNITS_PER_CLUSTER, 3),
        BIG).min(axis=1)
    cluster_aabb_max = np.where(
        cl_mask, unit_aabb_max.reshape(n_cl, UNITS_PER_CLUSTER, 3),
        -BIG).max(axis=1)
    cluster_valid = cl_mask[..., 0].any(axis=1)

    meta = np.zeros((n_cl, 8, 128), np.float32)
    meta[:, 0:3, :UNITS_PER_CLUSTER] = unit_aabb_min.reshape(
        n_cl, UNITS_PER_CLUSTER, 3).transpose(0, 2, 1)
    meta[:, 3:6, :UNITS_PER_CLUSTER] = unit_aabb_max.reshape(
        n_cl, UNITS_PER_CLUSTER, 3).transpose(0, 2, 1)
    meta[:, 6, :UNITS_PER_CLUSTER] = unit_valid.reshape(
        n_cl, UNITS_PER_CLUSTER).astype(np.float32)
    return dict(cluster_aabb_min=cluster_aabb_min,
                cluster_aabb_max=cluster_aabb_max,
                cluster_valid=cluster_valid, cluster_unit_meta=meta)


def _compressed_scene(aabb_min, aabb_max, tri_valid, unit_grid,
                      unit_aabb_min, unit_aabb_max, unit_valid, device,
                      **meta) -> DeviceScene:
    """Upload a compressed scene: records, AABBs and cluster tables only."""
    clusters = build_clusters(unit_aabb_min, unit_aabb_max, unit_valid)
    unit_gmat = meta.pop("unit_gmat", None)

    def dev(x):
        return _to_device(x, device)

    return DeviceScene(
        aabb_min=dev(aabb_min), aabb_max=dev(aabb_max),
        plane_t=None, plane_b=None, plane_n=None, plane_o=None,
        node_verts=None, node_minmax=None, node_pass=None,
        leaf_verts=None, leaf_mask=None, tri_valid=dev(tri_valid),
        unit_aabb_min=dev(unit_aabb_min), unit_aabb_max=dev(unit_aabb_max),
        unit_valid=dev(unit_valid), unit_leaf_idx=None,
        unit_qn=None, unit_n=None, unit_e2w2=None, unit_nrm=None,
        unit_nrm_pad=None, unit_q16=None, unit_grid=dev(unit_grid),
        **{k: dev(v) for k, v in clusters.items()},
        compressed=True, unit_gmat=dev(unit_gmat), **meta)


def build_compressed_scene(mesh: mesh_mod.MicroMesh,
                           device="cuda") -> DeviceScene:
    """Build the compressed (derive-at-trace-time) DeviceScene.

    Per unit (= one level-(L-3) subtree of one base triangle, 64 leaves):
    a (GRID_ROWS, GRID_LANES) record of its displaced grid-vertex
    positions plus an AABB — nothing else. Units are Morton-ordered by
    AABB center and grouped into the same 64-unit clusters as the
    standard build, so the culling and the kernel's cluster walk are
    unchanged; only the per-unit tables are derived at trace time.

    Mixed-level / decimated-presence meshes, and meshes below level 3,
    take the INDEXED variant (_build_compressed_indexed): records gain
    corner-index rows that encode each unit's stitched leaf topology.
    """
    uniform = (mesh.has_uniform_subdivision_level()
               and mesh.all_present())
    # Level < SUB_LEVEL triangles carry fewer than LPU leaves; the indexed
    # builder packs several triangles per unit instead of leaving unit
    # slots and leaf lanes empty.
    if not uniform or mesh.max_level < comp.SUB_LEVEL:
        return _build_compressed_indexed(mesh, device)

    lvl = mesh.max_level
    gcoords, su = comp.subtree_grid_coords(lvl)
    spt, gpts = gcoords.shape[:2]
    t_real = mesh.num_triangles
    u_real = t_real * spt
    u_pad = max(_round_up(u_real, UNITS_PER_CLUSTER), UNITS_PER_CLUSTER)

    unit_grid = np.zeros((u_pad, comp.GRID_ROWS, comp.GRID_LANES),
                         np.float32)
    unit_aabb_min = np.full((u_pad, 3), BIG, np.float32)
    unit_aabb_max = np.full((u_pad, 3), -BIG, np.float32)
    t_pad = max(_round_up(t_real, 8), 8)
    aabb_min = np.full((t_pad, 3), BIG, np.float32)
    aabb_max = np.full((t_pad, 3), -BIG, np.float32)
    tri_valid = np.zeros((t_pad,), bool)
    tri_valid[:t_real] = True

    chunk = max(1, 4_000_000 // max(spt * gpts, 1))
    for s in range(0, t_real, chunk):
        e = min(s + chunk, t_real)
        v0, v1, v2, d0, d1, d2, scales = precompute.base_and_scales(
            mesh, s, e)
        pos = comp.grid_positions(v0, v1, v2, d0, d1, d2, scales,
                                  gcoords, lvl)             # (n, spt, gp, 3)
        n = e - s
        unit_grid[s * spt:e * spt, 0:3, :gpts] = (
            pos.reshape(n * spt, gpts, 3).transpose(0, 2, 1))
        unit_aabb_min[s * spt:e * spt] = pos.min(axis=2).reshape(-1, 3)
        unit_aabb_max[s * spt:e * spt] = pos.max(axis=2).reshape(-1, 3)
        aabb_min[s:e] = pos.min(axis=(1, 2))
        aabb_max[s:e] = pos.max(axis=(1, 2))

    unit_valid = np.zeros((u_pad,), bool)
    unit_valid[:u_real] = True

    # Morton order over unit AABB centers (spatially coherent clusters).
    centers = 0.5 * (unit_aabb_min[:u_real] + unit_aabb_max[:u_real])
    order = np.argsort(_morton_codes(centers), kind="stable")
    perm = np.concatenate([order, np.arange(u_real, u_pad)])
    return _compressed_scene(
        aabb_min, aabb_max, tri_valid, unit_grid[perm], unit_aabb_min[perm],
        unit_aabb_max[perm], unit_valid, device, max_level=lvl,
        sub_level=su)


def _pack_compressed_class(mesh, ids, idx3, ref, gcoords, lvl_g, c0, k,
                           aabb_min, aabb_max, recs, u_mins, u_maxs):
    """Emit one class's triangles packed k-per-unit (level < SUB_LEVEL).

    The unit record's position rows hold k class-topology grids at lane
    blocks [t*gpts, (t+1)*gpts); the corner-index rows are the class's
    stitched topology shifted by t*gpts per slot — shared by every unit
    of the class. The max shifted lane is k*gpts - 1 <= GRID_LANES - 2, so
    the sentinel lane (GRID_LANES - 1, always zero) stays reserved; absent
    slots of the last unit keep zero positions, so their leaves derive
    det == 0. Triangles are Morton-ordered before grouping so unit AABBs
    stay tight."""
    spt, gpts = gcoords.shape[:2]
    assert spt == 1 and k * gpts <= comp.GRID_LANES - 1
    n_ids = len(ids)
    pos = np.zeros((n_ids, gpts, 3), np.float32)
    chunk = max(1, 4_000_000 // max(gpts, 1))
    for s in range(0, n_ids, chunk):
        sel = np.asarray(ids[s:s + chunk], np.int64)
        v0, v1, v2, d0, d1, d2, scales = precompute.base_and_scales(
            mesh, 0, 0, ids=sel)
        pos[s:s + sel.shape[0]] = comp.grid_positions(
            v0, v1, v2, d0, d1, d2, scales, gcoords, lvl_g)[:, 0]
    refm = ref[0, :gpts]                               # (gpts,)
    tmin = np.where(refm[None, :, None], pos, BIG).min(axis=1)
    tmax = np.where(refm[None, :, None], pos, -BIG).max(axis=1)
    ids_arr = np.asarray(ids, np.int64)
    aabb_min[ids_arr] = tmin
    aabb_max[ids_arr] = tmax

    order = np.argsort(_morton_codes(0.5 * (tmin + tmax)), kind="stable")
    n_units = -(-n_ids // k)
    slot = np.full((n_units * k,), -1, np.int64)
    slot[:n_ids] = order
    slot = slot.reshape(n_units, k)
    live = (slot >= 0)[..., None, None]                # (nu, k, 1, 1)
    src = pos[np.maximum(slot, 0)]                     # (nu, k, gpts, 3)
    mask = live & refm[None, None, :, None]
    rec = np.zeros((n_units, comp.IDX_ROWS, comp.GRID_LANES), np.float32)
    rec[:, 0:3, :k * gpts] = (np.where(mask, src, 0.0)
                              .reshape(n_units, k * gpts, 3)
                              .transpose(0, 2, 1))
    gidx = np.full((3, comp.LPU), comp.IDX_SENTINEL, np.int64)
    for t in range(k):
        gidx[:, t * c0:(t + 1) * c0] = (idx3[0, :, :c0].astype(np.int64)
                                        + t * gpts)
    rec[:, 3:6, :] = comp.pack_index_rows(gidx[None])[0]
    recs.append(rec)
    u_mins.append(np.where(mask, src, BIG).min(axis=(1, 2)))
    u_maxs.append(np.where(mask, src, -BIG).max(axis=(1, 2)))


def _build_compressed_indexed(mesh: mesh_mod.MicroMesh,
                              device) -> DeviceScene:
    """Indexed compressed build for mixed-level / stitched meshes.

    Triangles batch by (level, presence) class like the standard
    non-uniform build; each class computes its stitched unit topology once
    (compressed.stitched_unit_topology) and every triangle of the class
    emits `spt` units whose records hold displaced grid positions (rows
    0-2, unreferenced lanes zeroed) + the class's corner lane indices
    (rows 3-5). Sentinel columns derive zero triangles, rejected by the
    acceptance window.
    """
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(mesh.triangles):
        key = (t.subdivision_level, t.u_present.tobytes())
        groups.setdefault(key, []).append(i)

    t_real = mesh.num_triangles
    t_pad = max(_round_up(t_real, 8), 8)
    aabb_min = np.full((t_pad, 3), BIG, np.float32)
    aabb_max = np.full((t_pad, 3), -BIG, np.float32)
    tri_valid = np.zeros((t_pad,), bool)
    tri_valid[:t_real] = True

    recs, u_mins, u_maxs = [], [], []
    for (lvl_g, _), ids in groups.items():
        present = mesh.triangles[ids[0]].u_present
        idx3, ref, _ = comp.stitched_unit_topology(lvl_g, present)
        gcoords, _ = comp.subtree_grid_coords(lvl_g)
        spt, gpts = gcoords.shape[:2]
        # Small classes (level < SUB_LEVEL: one subtree with < LPU
        # leaves) pack k triangles per unit, so unit count and lane
        # occupancy match the standard build.
        c0 = int((idx3[0, 0] != comp.IDX_SENTINEL).sum()) if spt else 0
        k = 1
        if spt == 1 and c0:
            k = max(1, min(comp.LPU // c0,
                           (comp.GRID_LANES - 1) // max(gpts, 1)))
        if k > 1:
            _pack_compressed_class(mesh, ids, idx3, ref, gcoords, lvl_g,
                                   c0, k, aabb_min, aabb_max,
                                   recs, u_mins, u_maxs)
            continue
        idxrows = comp.pack_index_rows(idx3)          # (spt, 3, GRID_LANES)
        refs = ref[:, :gpts]                          # (spt, gpts)
        chunk = max(1, 4_000_000 // max(spt * gpts, 1))
        for s in range(0, len(ids), chunk):
            sel = np.asarray(ids[s:s + chunk], np.int64)
            v0, v1, v2, d0, d1, d2, scales = precompute.base_and_scales(
                mesh, 0, 0, ids=sel)
            pos = comp.grid_positions(v0, v1, v2, d0, d1, d2, scales,
                                      gcoords, lvl_g)  # (n, spt, gpts, 3)
            n = sel.shape[0]
            rm = refs[None, :, :, None]
            rec = np.zeros((n, spt, comp.IDX_ROWS, comp.GRID_LANES),
                           np.float32)
            rec[:, :, 0:3, :gpts] = np.where(rm, pos, 0.0).transpose(
                0, 1, 3, 2)
            rec[:, :, 3:6, :] = idxrows[None]
            recs.append(rec.reshape(n * spt, comp.IDX_ROWS,
                                    comp.GRID_LANES))
            umin = np.where(rm, pos, BIG).min(axis=2)   # (n, spt, 3)
            umax = np.where(rm, pos, -BIG).max(axis=2)
            u_mins.append(umin.reshape(-1, 3))
            u_maxs.append(umax.reshape(-1, 3))
            aabb_min[sel] = umin.min(axis=1)
            aabb_max[sel] = umax.max(axis=1)

    unit_grid = np.concatenate(recs) if recs else np.zeros(
        (0, comp.IDX_ROWS, comp.GRID_LANES), np.float32)
    unit_aabb_min = np.concatenate(u_mins) if u_mins else np.zeros(
        (0, 3), np.float32)
    unit_aabb_max = np.concatenate(u_maxs) if u_maxs else np.zeros(
        (0, 3), np.float32)
    u_real = unit_grid.shape[0]
    u_pad = max(_round_up(u_real, UNITS_PER_CLUSTER), UNITS_PER_CLUSTER)

    # Morton order over unit AABB centers, zero-record padding (all-zero
    # indexed records gather lane 0 of zero positions -> degenerate).
    centers = 0.5 * (unit_aabb_min + unit_aabb_max)
    order = (np.argsort(_morton_codes(centers), kind="stable")
             if u_real else np.zeros(0, np.int64))
    pad = u_pad - u_real
    unit_grid = np.concatenate(
        [unit_grid[order],
         np.zeros((pad, comp.IDX_ROWS, comp.GRID_LANES), np.float32)])
    unit_aabb_min = np.concatenate(
        [unit_aabb_min[order], np.full((pad, 3), BIG, np.float32)])
    unit_aabb_max = np.concatenate(
        [unit_aabb_max[order], np.full((pad, 3), -BIG, np.float32)])
    unit_valid = np.zeros((u_pad,), bool)
    unit_valid[:u_real] = True

    # Single-topology detection: when every valid unit carries the same
    # corner-index rows (one (level, presence) class, e.g. a uniform
    # level-2 scene packed k per unit), the scene keeps one shared gather
    # matrix and the kernel reads the corner lanes from it.
    unit_gmat = None
    if u_real and bool((unit_grid[:u_real, 3:6]
                        == unit_grid[0:1, 3:6]).all()):
        unit_gmat = comp.gather_matrix_from_indices(
            comp._corner_indices_np(unit_grid[0:1])[0])
    return _compressed_scene(
        aabb_min, aabb_max, tri_valid, unit_grid, unit_aabb_min,
        unit_aabb_max, unit_valid, device, max_level=mesh.max_level,
        sub_level=comp.SUB_LEVEL, indexed=True, unit_gmat=unit_gmat)


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits of x to every third bit (Morton interleave helper)."""
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
    return x


def _morton_codes(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points quantized over their own bounds."""
    lo = points.min(axis=0)
    span = np.maximum(points.max(axis=0) - lo, 1e-20)
    q = np.clip(((points - lo) / span) * 1023.0, 0.0, 1023.0).astype(np.uint64)
    return (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << np.uint64(1))
            | (_part1by2(q[:, 2]) << np.uint64(2)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
