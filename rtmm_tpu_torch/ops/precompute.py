"""Per-scene host precompute: the ray-independent micro-mesh tables.

Ports the reference's CPU precompute passes —
  - displacement scales            (framework/src/mesh.cpp:386-420)
  - hierarchical min/max heights   (framework/src/mesh.cpp:119-198)
  - hierarchical edge-expansion deltas (framework/src/mesh.cpp:248-384)
  - per-base-triangle AABBs        (shaders/createAABBs.hlsl:21-47)
— plus everything the reference recomputes *per ray on the GPU* that is in
fact ray-independent: displaced 2D node corner triangles, their delta
expansion (intersection.hlsl:151-202), and the displaced leaf micro-triangle
3D vertices (intersection.hlsl:465-470). Precomputing those once per scene is
the core TPU-first redesign: the per-ray Pallas/XLA traversal then only does
2D edge tests + height-band pruning + Möller-Trumbore on dense tables.

All results are float32 to match the reference's C++/HLSL arithmetic.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models import mesh as mesh_mod
from . import subdivision

BIG = np.float32(1e30)


def plane_frame(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """TBN plane of a base triangle (intersection.hlsl:490-500).

    T = normalize(e1), N = normalize(cross(e1, e2)), B = normalize(cross(N, T)),
    origin = v0.
    """
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    n = _normalize(np.cross(e1, e2))
    t = _normalize(e1)
    b = _normalize(np.cross(n, t))
    return t, b, n, v0.astype(np.float32)


def project_onto(points: np.ndarray, t, b, origin) -> np.ndarray:
    """Plane.projectOnto (intersection.hlsl:13-17): (dot(p-o,T), dot(p-o,B))."""
    moved = points.astype(np.float32) - origin
    return np.stack([moved @ t, moved @ b], axis=-1).astype(np.float32)


def displacement_scales(tri: mesh_mod.MicroTriangle,
                        mesh: mesh_mod.MicroMesh) -> np.ndarray:
    """Per micro-vertex displacement scale, -1 sentinel when absent
    (mesh.cpp:398-416)."""
    bidx = tri.base_vertex_indices
    a, b, c = (mesh.positions[bidx[0]], mesh.positions[bidx[1]],
               mesh.positions[bidx[2]])
    bc = mesh_mod.barycentric_coords(a, b, c, tri.u_positions)  # (M, 3)
    d = (bc[:, :1] * mesh.directions[bidx[0]]
         + bc[:, 1:2] * mesh.directions[bidx[1]]
         + bc[:, 2:3] * mesh.directions[bidx[2]]).astype(np.float32)
    disp = tri.u_displacements.astype(np.float32)
    # The reference takes the ratio of the first nonzero direction component
    # (mesh.cpp:408-412), which blows up when that component is tiny but
    # nonzero. Since displacement == scale * direction by construction, the
    # least-squares ratio dot(disp, d)/dot(d, d) is the numerically robust
    # equivalent (identical for exactly parallel data, stable otherwise).
    dd = (d * d).sum(axis=1)
    scale = _safe_div((disp * d).sum(axis=1), dd).astype(np.float32)
    scale = np.where(dd == 0.0, 0.0, scale)
    return np.where(tri.u_present, scale, np.float32(-1.0)).astype(np.float32)


@dataclasses.dataclass
class TriangleTables:
    """All precomputed tables for one base triangle."""

    level: int
    plane_t: np.ndarray          # (3,)
    plane_b: np.ndarray
    plane_n: np.ndarray
    plane_o: np.ndarray
    aabb_min: np.ndarray         # (3,)
    aabb_max: np.ndarray
    scales: np.ndarray           # (M,) with -1 sentinel
    node_minmax: np.ndarray      # (NI_t, 2) levels 0..level-1, level-ordered
    node_delta: np.ndarray       # (NI_t,)
    node_verts: np.ndarray       # (NI_t, 3, 2) delta-expanded displaced 2D
    leaf_slots: np.ndarray       # (NL,) slot in [0, 4^level)
    leaf_verts: np.ndarray       # (NL, 3, 3) displaced 3D micro-triangles
    tess_verts: np.ndarray       # (F, 3, 3) displaced uFaces (tessellated GT)


def build_triangle_tables(tri: mesh_mod.MicroTriangle,
                          mesh: mesh_mod.MicroMesh) -> TriangleTables:
    lvl = tri.subdivision_level
    bidx = tri.base_vertex_indices
    v0, v1, v2 = (mesh.positions[bidx[0]], mesh.positions[bidx[1]],
                  mesh.positions[bidx[2]])
    pt, pb, pn, po = plane_frame(v0, v1, v2)

    disp = tri.u_displacements.astype(np.float32)
    displaced = (tri.u_positions + disp).astype(np.float32)

    # AABB over displaced micro-vertices (createAABBs.hlsl:30-46).
    aabb_min = displaced.min(axis=0)
    aabb_max = displaced.max(axis=0)

    scales = displacement_scales(tri, mesh)
    heights = (disp @ pn).astype(np.float32)          # mesh.cpp:153
    pts2d = project_onto(displaced, pt, pb, po)       # mesh.cpp:292

    ni = subdivision.num_internal_nodes(lvl)
    node_minmax = np.full((ni, 2), 0.0, dtype=np.float32)
    node_delta = np.zeros((ni,), dtype=np.float32)
    node_verts = np.zeros((ni, 3, 2), dtype=np.float32)

    # (The JAX package can route this block through its native C++
    # library; the port keeps the NumPy path only — same tables.)
    if lvl > 0:
        coords_all = subdivision.grid_coords(lvl)          # (M, 2)
        face_coords = coords_all[tri.u_faces]              # (F, 3, 2)
        paths = subdivision.face_node_paths(face_coords, lvl)  # (F, lvl+1)
        fheights = heights[tri.u_faces]                    # (F, 3)
        fpts = pts2d[tri.u_faces]                          # (F, 3, 2)
        tables = subdivision.node_corner_table(lvl)
        for l in range(lvl):
            off = subdivision.level_offset(l)
            count = 4**l
            node_of_face = paths[:, l]
            # min/max heights per node (mesh.cpp:145-160)
            mn = np.full(count, BIG, dtype=np.float32)
            mx = np.full(count, -BIG, dtype=np.float32)
            np.minimum.at(mn, np.repeat(node_of_face, 3), fheights.reshape(-1))
            np.maximum.at(mx, np.repeat(node_of_face, 3), fheights.reshape(-1))
            empty = mn > mx
            # Reference leaves min/max at (+1e5, -1e5) for empty nodes
            # (mesh.cpp:149) which prunes them — keep that behavior but with
            # our sentinels.
            node_minmax[off:off + count, 0] = np.where(empty, BIG, mn)
            node_minmax[off:off + count, 1] = np.where(empty, -BIG, mx)

            # delta per node (mesh.cpp:248-272,319-331)
            corner_coords = tables[l]                      # (count, 3, 2)
            scale_up = 2 ** (lvl - l)                      # finest units step
            corner2d = pts2d[subdivision.grid_index(corner_coords)]
            delta = _node_deltas(corner2d, node_of_face, fpts, count)
            node_delta[off:off + count] = delta
            node_verts[off:off + count] = expand_triangle(corner2d, delta)

    # Leaf micro-triangles with stitching (intersection.hlsl:339-376,465-470).
    present = tri.u_present

    def present_at(c):
        return present[subdivision.grid_index(c)]

    leaf_slots, leaf_corners = subdivision.enumerate_leaves(lvl, present_at)
    leaf_verts = _leaf_verts_3d(leaf_corners, lvl, v0, v1, v2,
                                mesh.directions[bidx[0]],
                                mesh.directions[bidx[1]],
                                mesh.directions[bidx[2]], scales)

    tess_verts = displaced[tri.u_faces]                    # (F, 3, 3)

    return TriangleTables(
        level=lvl, plane_t=pt, plane_b=pb, plane_n=pn, plane_o=po,
        aabb_min=aabb_min, aabb_max=aabb_max, scales=scales,
        node_minmax=node_minmax, node_delta=node_delta, node_verts=node_verts,
        leaf_slots=leaf_slots, leaf_verts=leaf_verts, tess_verts=tess_verts)


def base_and_scales(mesh: mesh_mod.MicroMesh, start: int, stop: int,
                    ids=None):
    """Base corner positions/directions + displacement scales for a slice
    (or explicit `ids` — triangles must share grid shape, i.e. one
    (level, presence) class) of a mesh (the inputs of the compressed-unit
    build). Returns (v0, v1, v2, d0, d1, d2 (N, 3), scales (N, M)) — the
    exact scale arithmetic of build_uniform_tables (mesh.cpp:398-416
    robust dot-ratio form)."""
    tris = (mesh.triangles[start:stop] if ids is None
            else [mesh.triangles[int(i)] for i in ids])
    bidx = np.stack([t.base_vertex_indices for t in tris])       # (N, 3)
    u_pos = np.stack([t.u_positions for t in tris]).astype(np.float32)
    u_disp = np.stack([t.u_displacements for t in tris]).astype(np.float32)
    v0 = mesh.positions[bidx[:, 0]].astype(np.float32)
    v1 = mesh.positions[bidx[:, 1]].astype(np.float32)
    v2 = mesh.positions[bidx[:, 2]].astype(np.float32)
    d0 = mesh.directions[bidx[:, 0]].astype(np.float32)
    d1 = mesh.directions[bidx[:, 1]].astype(np.float32)
    d2 = mesh.directions[bidx[:, 2]].astype(np.float32)
    bc = _barycentric_batch(v0, v1, v2, u_pos)                   # (N, M, 3)
    d = (bc[..., 0:1] * d0[:, None] + bc[..., 1:2] * d1[:, None]
         + bc[..., 2:3] * d2[:, None]).astype(np.float32)
    dd = (d * d).sum(-1)
    scales = _safe_div((u_disp * d).sum(-1), dd).astype(np.float32)
    scales = np.where(dd == 0.0, 0.0, scales).astype(np.float32)
    return v0, v1, v2, d0, d1, d2, scales


def build_uniform_tables(mesh: mesh_mod.MicroMesh, start: int, stop: int
                         ) -> dict:
    """Batched TriangleTables for a slice of a uniform-level, all-present
    mesh — the same math as build_triangle_tables vectorized over the
    triangle axis, which turns the host precompute from a per-triangle
    Python loop (~1.5 ms/triangle) into dense NumPy, enabling real-scale
    scenes (10^4-10^6 base triangles).

    Returns a dict of arrays with leading dim (stop - start): plane_{t,b,n,o}
    (N,3), aabb_{min,max} (N,3), node_verts (N,NI,3,2), node_minmax (N,NI,2),
    node_delta (N,NI), leaf_verts (N,F,3,3), tess_verts (N,F,3,3),
    scales (N,M). Leaf slot k holds the uniform-case leaf in emission order
    (slots are exactly arange(4^level), matching enumerate_leaves with full
    presence).
    """
    tris = mesh.triangles[start:stop]
    lvl = tris[0].subdivision_level
    n = len(tris)
    bidx = np.stack([t.base_vertex_indices for t in tris])       # (N, 3)
    u_pos = np.stack([t.u_positions for t in tris]).astype(np.float32)
    u_disp = np.stack([t.u_displacements for t in tris]).astype(np.float32)
    v0 = mesh.positions[bidx[:, 0]].astype(np.float32)
    v1 = mesh.positions[bidx[:, 1]].astype(np.float32)
    v2 = mesh.positions[bidx[:, 2]].astype(np.float32)
    d0 = mesh.directions[bidx[:, 0]].astype(np.float32)
    d1 = mesh.directions[bidx[:, 1]].astype(np.float32)
    d2 = mesh.directions[bidx[:, 2]].astype(np.float32)

    def nrm_rows(x):
        return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                               1e-20)).astype(np.float32)

    e1b = v1 - v0
    e2b = v2 - v0
    pn = nrm_rows(np.cross(e1b, e2b))
    pt = nrm_rows(e1b)
    pb = nrm_rows(np.cross(pn, pt))

    displaced = u_pos + u_disp                                   # (N, M, 3)
    aabb_min = displaced.min(axis=1)
    aabb_max = displaced.max(axis=1)

    # Batched displacement scales (mesh.cpp:398-416, robust dot-ratio form).
    bc = _barycentric_batch(v0, v1, v2, u_pos)                   # (N, M, 3)
    d = (bc[..., 0:1] * d0[:, None] + bc[..., 1:2] * d1[:, None]
         + bc[..., 2:3] * d2[:, None]).astype(np.float32)
    dd = (d * d).sum(-1)
    scales = _safe_div((u_disp * d).sum(-1), dd).astype(np.float32)
    scales = np.where(dd == 0.0, 0.0, scales).astype(np.float32)

    heights = (u_disp * pn[:, None]).sum(-1).astype(np.float32)  # (N, M)
    moved = displaced - po_broadcast(v0, u_pos)
    pts2d = np.stack([(moved * pt[:, None]).sum(-1),
                      (moved * pb[:, None]).sum(-1)],
                     axis=-1).astype(np.float32)                 # (N, M, 2)

    ni = subdivision.num_internal_nodes(lvl)
    node_minmax = np.zeros((n, max(ni, 1), 2), np.float32)[:, :ni]
    node_delta = np.zeros((n, ni), np.float32)
    node_verts = np.zeros((n, ni, 3, 2), np.float32)

    leaf_corners = subdivision.enumerate_leaves(
        lvl, lambda c: np.ones(c.shape[:-1], dtype=bool))[1]     # (F, 3, 2)
    fidx = subdivision.grid_index(leaf_corners)                  # (F, 3)
    f = leaf_corners.shape[0]

    if lvl > 0:
        paths = subdivision.face_node_paths(leaf_corners, lvl)   # (F, lvl+1)
        tables = subdivision.node_corner_table(lvl)
        fheights = heights[:, fidx]                              # (N, F, 3)
        fpts = pts2d[:, fidx]                                    # (N, F, 3, 2)
        for l in range(lvl):
            off = subdivision.level_offset(l)
            count = 4**l
            fpn = f // count
            order = np.argsort(paths[:, l], kind="stable")       # contiguous
            fh = fheights[:, order].reshape(n, count, fpn * 3)
            node_minmax[:, off:off + count, 0] = fh.min(axis=2)
            node_minmax[:, off:off + count, 1] = fh.max(axis=2)
            corner2d = pts2d[:, subdivision.grid_index(tables[l])]
            fp = fpts[:, order].reshape(n, count, fpn, 3, 2)
            delta = _node_deltas_batched(corner2d, fp)
            node_delta[:, off:off + count] = delta
            node_verts[:, off:off + count] = expand_triangle(corner2d, delta)

    # Displaced 3D leaves, closed form (same as _leaf_verts_3d, batched).
    denom = max(2**lvl, 1)
    u = leaf_corners[..., 0] / denom                             # (F, 3)
    w = leaf_corners[..., 1] / denom
    lbc = np.stack([1.0 - u, u - w, w], axis=-1).astype(np.float32)  # (F,3,3)
    base = (lbc[None, ..., 0:1] * v0[:, None, None]
            + lbc[None, ..., 1:2] * v1[:, None, None]
            + lbc[None, ..., 2:3] * v2[:, None, None])
    ldirs = (lbc[None, ..., 0:1] * d0[:, None, None]
             + lbc[None, ..., 1:2] * d1[:, None, None]
             + lbc[None, ..., 2:3] * d2[:, None, None])
    s = scales[:, fidx]                                          # (N, F, 3)
    leaf_verts = (base + s[..., None] * ldirs).astype(np.float32)

    tess_verts = displaced[:, fidx].astype(np.float32)           # (N, F, 3, 3)

    return dict(level=lvl, plane_t=pt, plane_b=pb, plane_n=pn, plane_o=v0,
                aabb_min=aabb_min, aabb_max=aabb_max, scales=scales,
                node_minmax=node_minmax, node_delta=node_delta,
                node_verts=node_verts, leaf_verts=leaf_verts,
                tess_verts=tess_verts)


def build_group_tables(mesh: mesh_mod.MicroMesh, idx) -> dict:
    """Batched TriangleTables for triangles sharing (level, presence).

    idx: triangle indices whose subdivision level AND u_present pattern are
    identical — the stitched leaf topology (u_faces, enumerate_leaves) is
    then shared, so every per-triangle quantity vectorizes over the group.
    This turns the mixed-level/decimated scene build from a ~1.5 ms/tri
    Python loop into dense NumPy over pattern groups (a real stitched
    asset has a handful of patterns: interior all-present + a few edge
    decimation cases).

    Returns build_uniform_tables-style arrays plus the group's shared
    leaf_slots (NL,) — leaf_verts rows follow enumerate_leaves order.
    """
    idx = np.asarray(idx, np.int64)
    tris = [mesh.triangles[i] for i in idx]
    t0 = tris[0]
    lvl = t0.subdivision_level
    present = t0.u_present
    n = len(tris)
    bidx = np.stack([t.base_vertex_indices for t in tris])
    u_pos = np.stack([t.u_positions for t in tris]).astype(np.float32)
    u_disp = np.stack([t.u_displacements for t in tris]).astype(np.float32)
    v0 = mesh.positions[bidx[:, 0]].astype(np.float32)
    v1 = mesh.positions[bidx[:, 1]].astype(np.float32)
    v2 = mesh.positions[bidx[:, 2]].astype(np.float32)
    d0 = mesh.directions[bidx[:, 0]].astype(np.float32)
    d1 = mesh.directions[bidx[:, 1]].astype(np.float32)
    d2 = mesh.directions[bidx[:, 2]].astype(np.float32)

    def nrm_rows(x):
        return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                               1e-20)).astype(np.float32)

    e1b = v1 - v0
    e2b = v2 - v0
    pn = nrm_rows(np.cross(e1b, e2b))
    pt = nrm_rows(e1b)
    pb = nrm_rows(np.cross(pn, pt))

    displaced = u_pos + u_disp                                   # (N, M, 3)
    aabb_min = displaced.min(axis=1)
    aabb_max = displaced.max(axis=1)

    bc = _barycentric_batch(v0, v1, v2, u_pos)                   # (N, M, 3)
    d = (bc[..., 0:1] * d0[:, None] + bc[..., 1:2] * d1[:, None]
         + bc[..., 2:3] * d2[:, None]).astype(np.float32)
    dd = (d * d).sum(-1)
    scales = _safe_div((u_disp * d).sum(-1), dd).astype(np.float32)
    scales = np.where(dd == 0.0, 0.0, scales).astype(np.float32)
    scales = np.where(present[None, :], scales,
                      np.float32(-1.0)).astype(np.float32)

    heights = (u_disp * pn[:, None]).sum(-1).astype(np.float32)  # (N, M)
    moved = displaced - po_broadcast(v0, u_pos)
    pts2d = np.stack([(moved * pt[:, None]).sum(-1),
                      (moved * pb[:, None]).sum(-1)],
                     axis=-1).astype(np.float32)                 # (N, M, 2)

    faces = t0.u_faces                                           # shared
    ni = subdivision.num_internal_nodes(lvl)
    node_minmax = np.zeros((n, ni, 2), np.float32)
    node_delta = np.zeros((n, ni), np.float32)
    node_verts = np.zeros((n, ni, 3, 2), np.float32)

    if lvl > 0:
        coords_all = subdivision.grid_coords(lvl)
        face_coords = coords_all[faces]                          # (F, 3, 2)
        paths = subdivision.face_node_paths(face_coords, lvl)
        fheights = heights[:, faces]                             # (N, F, 3)
        fpts = pts2d[:, faces]                                   # (N, F, 3, 2)
        tables = subdivision.node_corner_table(lvl)
        f = faces.shape[0]
        for l in range(lvl):
            off = subdivision.level_offset(l)
            count = 4**l
            nof = paths[:, l]                                    # (F,)
            # Scatter min/max heights per (tri, node): stitched topologies
            # have UNEVEN faces-per-node, so use flat scatter indices
            # instead of build_uniform_tables' equal-count reshape.
            flat = (np.arange(n)[:, None, None] * count
                    + nof[None, :, None])                        # (N, F, 1)
            flat3 = np.broadcast_to(flat, (n, f, 3)).reshape(-1)
            mn = np.full(n * count, BIG, np.float32)
            mx = np.full(n * count, -BIG, np.float32)
            np.minimum.at(mn, flat3, fheights.reshape(-1))
            np.maximum.at(mx, flat3, fheights.reshape(-1))
            mn = mn.reshape(n, count)
            mx = mx.reshape(n, count)
            empty = mn > mx
            node_minmax[:, off:off + count, 0] = np.where(empty, BIG, mn)
            node_minmax[:, off:off + count, 1] = np.where(empty, -BIG, mx)

            corner2d = pts2d[:, subdivision.grid_index(tables[l])]
            c = corner2d[np.arange(n)[:, None], nof[None, :]]    # (N, F, 3, 2)
            a_ = c[:, :, [0, 1, 2]][:, :, :, None, :]    # (N, F, 3e, 1, 2)
            b_ = c[:, :, [1, 2, 0]][:, :, :, None, :]
            ce1 = c[:, :, 1] - c[:, :, 0]
            ce2 = c[:, :, 2] - c[:, :, 0]
            ccw = (ce1[..., 0] * ce2[..., 1]
                   - ce1[..., 1] * ce2[..., 0]) > 0.0            # (N, F)
            p = fpts[:, :, None, :, :]                   # (N, F, 1, 3p, 2)
            ab = b_ - a_
            ap = p - a_
            ab_len2 = (ab * ab).sum(-1)
            tt = np.clip(_safe_div((ap * ab).sum(-1), ab_len2), 0.0, 1.0)
            closest = a_ + tt[..., None] * ab
            dist = np.linalg.norm(p - closest, axis=-1)          # (N,F,3,3)
            cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
            outside = np.where(ccw[..., None, None], cross <= 0.0,
                               ~(cross <= 0.0))
            contrib = np.where(outside, dist, 0.0).reshape(n, f, 9)
            delta = np.zeros(n * count, np.float32)
            flat9 = np.broadcast_to(flat, (n, f, 9)).reshape(-1)
            np.maximum.at(delta, flat9,
                          contrib.reshape(-1).astype(np.float32))
            delta = delta.reshape(n, count)
            node_delta[:, off:off + count] = delta
            node_verts[:, off:off + count] = expand_triangle(corner2d, delta)

    def present_at(c):
        return present[subdivision.grid_index(c)]

    leaf_slots, leaf_corners = subdivision.enumerate_leaves(lvl, present_at)
    denom = max(2**lvl, 1)
    u = leaf_corners[..., 0] / denom                             # (NL, 3)
    w = leaf_corners[..., 1] / denom
    lbc = np.stack([1.0 - u, u - w, w], axis=-1).astype(np.float32)
    base = (lbc[None, ..., 0:1] * v0[:, None, None]
            + lbc[None, ..., 1:2] * v1[:, None, None]
            + lbc[None, ..., 2:3] * v2[:, None, None])
    ldirs = (lbc[None, ..., 0:1] * d0[:, None, None]
             + lbc[None, ..., 1:2] * d1[:, None, None]
             + lbc[None, ..., 2:3] * d2[:, None, None])
    s = scales[:, subdivision.grid_index(leaf_corners)]          # (N, NL, 3)
    leaf_verts = (base + s[..., None] * ldirs).astype(np.float32)

    tess_verts = displaced[:, faces].astype(np.float32)

    return dict(level=lvl, plane_t=pt, plane_b=pb, plane_n=pn, plane_o=v0,
                aabb_min=aabb_min, aabb_max=aabb_max, scales=scales,
                node_minmax=node_minmax, node_delta=node_delta,
                node_verts=node_verts, leaf_slots=leaf_slots,
                leaf_verts=leaf_verts, tess_verts=tess_verts)


def po_broadcast(v0: np.ndarray, u_pos: np.ndarray) -> np.ndarray:
    """Plane origin (= v0) broadcast over the micro-vertex axis."""
    return np.broadcast_to(v0[:, None], u_pos.shape)


def _barycentric_batch(a, b, c, points):
    """Batched barycentric coords: a/b/c (N, 3), points (N, M, 3)."""
    v0 = (b - a).astype(np.float64)
    v1 = (c - a).astype(np.float64)
    v2 = points.astype(np.float64) - a[:, None]
    d00 = (v0 * v0).sum(-1)[:, None]
    d01 = (v0 * v1).sum(-1)[:, None]
    d11 = (v1 * v1).sum(-1)[:, None]
    d20 = (v2 * v0[:, None]).sum(-1)
    d21 = (v2 * v1[:, None]).sum(-1)
    denom = d00 * d11 - d01 * d01
    beta = (d11 * d20 - d01 * d21) / denom
    gamma = (d00 * d21 - d01 * d20) / denom
    alpha = 1.0 - beta - gamma
    return np.stack([alpha, beta, gamma], axis=-1)


def _node_deltas_batched(corner2d: np.ndarray, fp: np.ndarray) -> np.ndarray:
    """Batched _node_deltas: corner2d (N, count, 3, 2) node corners,
    fp (N, count, fpn, 3, 2) member face points -> (N, count)."""
    c = corner2d
    a_ = c[:, :, [0, 1, 2], :][:, :, None, :, None, :]  # (N,cnt,1,3e,1,2)
    b_ = c[:, :, [1, 2, 0], :][:, :, None, :, None, :]
    e1 = c[:, :, 1] - c[:, :, 0]
    e2 = c[:, :, 2] - c[:, :, 0]
    ccw = (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]) > 0.0

    p = fp[:, :, :, None, :, :]                         # (N,cnt,fpn,1,3p,2)
    ab = b_ - a_
    ap = p - a_
    ab_len2 = (ab * ab).sum(-1)
    t = np.clip(_safe_div((ap * ab).sum(-1), ab_len2), 0.0, 1.0)
    closest = a_ + t[..., None] * ab
    dist = np.linalg.norm(p - closest, axis=-1)         # (N,cnt,fpn,3,3)
    cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
    is_right = cross <= 0.0
    outside = np.where(ccw[..., None, None, None], is_right, ~is_right)
    contrib = np.where(outside, dist, 0.0)
    return contrib.max(axis=(2, 3, 4)).astype(np.float32)


def _node_deltas(corner2d: np.ndarray, node_of_face: np.ndarray,
                 fpts: np.ndarray, count: int) -> np.ndarray:
    """Max outside-distance of member points to node edges (mesh.cpp:248-272).

    corner2d: (count, 3, 2) displaced projected node corners.
    node_of_face: (F,) node index per face; fpts: (F, 3, 2) member points.
    """
    c = corner2d[node_of_face]                     # (F, 3, 2)
    a_ = c[:, [0, 1, 2]]                           # edge starts (F, 3, 2)
    b_ = c[:, [1, 2, 0]]                           # edge ends
    e1 = c[:, 1] - c[:, 0]
    e2 = c[:, 2] - c[:, 0]
    ccw = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > 0.0  # Triangle2D.isCCW

    p = fpts[:, None, :, :]                        # (F, 1, 3pts, 2)
    a = a_[:, :, None, :]                          # (F, 3edges, 1, 2)
    b = b_[:, :, None, :]
    ab = b - a
    ap = p - a
    ab_len2 = (ab * ab).sum(-1)
    t = np.clip(_safe_div((ap * ab).sum(-1), ab_len2), 0.0, 1.0)
    closest = a + t[..., None] * ab
    dist = np.linalg.norm(p - closest, axis=-1)    # (F, 3, 3)
    cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
    is_right = cross <= 0.0                        # Edge2D.isRight
    outside = np.where(ccw[:, None, None], is_right, ~is_right)
    contrib = np.where(outside, dist, 0.0).reshape(fpts.shape[0], -1)

    delta = np.zeros(count, dtype=np.float32)
    np.maximum.at(delta, np.repeat(node_of_face, contrib.shape[1]),
                  contrib.reshape(-1).astype(np.float32))
    return delta


def expand_triangle(verts: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """expandTriangle (intersection.hlsl:151-172), vectorized.

    verts: (..., 3, 2); delta: (...,). Moves each edge outward by delta and
    intersects adjacent expanded edges to form the new corners.
    """
    verts = verts.astype(np.float64)
    v0, v1, v2 = verts[..., 0, :], verts[..., 1, :], verts[..., 2, :]
    ods = []
    for s, e in ((v0, v1), (v1, v2), (v2, v0)):
        d = e - s
        outward = np.stack([d[..., 1], -d[..., 0]], axis=-1)
        norm = np.maximum(np.linalg.norm(outward, axis=-1, keepdims=True),
                          1e-20)
        ods.append(delta[..., None] * outward / norm)
    od0, od1, od2 = ods
    new0 = _line_intersect(v0 + od0, v1 + od0, v2 + od2, v0 + od2)
    new1 = _line_intersect(v0 + od0, v1 + od0, v1 + od1, v2 + od1)
    new2 = _line_intersect(v1 + od1, v2 + od1, v2 + od2, v0 + od2)
    return np.stack([new0, new1, new2], axis=-2).astype(np.float32)


def _line_intersect(p1, p2, p3, p4):
    """Line-line intersection (intersection.hlsl:136-145)."""
    val1 = p1[..., 0] * p2[..., 1] - p1[..., 1] * p2[..., 0]
    val2 = p3[..., 0] * p4[..., 1] - p3[..., 1] * p4[..., 0]
    denom = ((p1[..., 0] - p2[..., 0]) * (p3[..., 1] - p4[..., 1])
             - (p1[..., 1] - p2[..., 1]) * (p3[..., 0] - p4[..., 0]))
    denom = np.where(np.abs(denom) < 1e-20, 1e-20, denom)
    px = (val1 * (p3[..., 0] - p4[..., 0])
          - (p1[..., 0] - p2[..., 0]) * val2) / denom
    py = (val1 * (p3[..., 1] - p4[..., 1])
          - (p1[..., 1] - p2[..., 1]) * val2) / denom
    return np.stack([px, py], axis=-1)


def _leaf_verts_3d(leaf_corners: np.ndarray, lvl: int, v0, v1, v2,
                   d0, d1, d2, scales: np.ndarray) -> np.ndarray:
    """Displaced 3D leaf vertices (intersection.hlsl:465-470).

    vs3D = unproject(pos2d, 0) + scale * bc-interpolated direction. Because
    the base corners lie on the plane and micro positions are grid-affine,
    unproject(project(p)) == bc-lerp of the base corner positions, so we
    evaluate that closed form directly.
    """
    denom = max(2**lvl, 1)
    u = leaf_corners[..., 0] / denom               # (NL, 3)
    w = leaf_corners[..., 1] / denom
    bc = np.stack([1.0 - u, u - w, w], axis=-1).astype(np.float32)  # (NL,3,3)
    base = (bc[..., 0:1] * v0 + bc[..., 1:2] * v1 + bc[..., 2:3] * v2)
    dirs = (bc[..., 0:1] * d0 + bc[..., 1:2] * d1 + bc[..., 2:3] * d2)
    s = scales[subdivision.grid_index(leaf_corners)]        # (NL, 3)
    return (base + s[..., None] * dirs).astype(np.float32)


def _normalize(v: np.ndarray) -> np.ndarray:
    return (v / max(np.linalg.norm(v), 1e-20)).astype(np.float32)


def _safe_div(a, b):
    return np.divide(a, np.where(b == 0.0, 1.0, b),
                     dtype=np.float64 if a.dtype == np.float64 else np.float32)
