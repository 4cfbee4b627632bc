"""Micro-mesh asset loading: gltf(+bary), npz, and save-out.

Port of the reference asset pipeline (GPUMesh::loadGLTFMeshGPU,
src/GPUMesh.cpp:143-152 + TinyGLTFLoader::toMesh,
framework/src/TinyGLTFLoader.cpp:26-105) without the external
umeshtools_core dependency:

  * `.gltf`/`.glb` + `.bary`: base mesh from glTF, displacement scalars +
    subdivision levels + edge-decimation flags from the bary container;
    micro positions are barycentric-affine, displacement vector =
    scalar * interpolated per-vertex direction.
  * `.npz`: an umeshtools-style SubdivisionMesh dump (per-face F/V/VD +
    base_V/base_VD) — this path is the literal semantic port of
    TinyGLTFLoader::toMesh, including presence-by-face-reference and
    epsilon-matched per-vertex directions (TinyGLTFLoader.cpp:59-105).
"""
from __future__ import annotations

import os

import numpy as np

from ..models import mesh as mesh_mod
from ..ops import subdivision
from . import bary as bary_mod
from . import gltf as gltf_mod


def load_micromesh(path: str) -> mesh_mod.MicroMesh:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        return load_gltf_bary(path)
    if ext == ".npz":
        return load_npz(path)
    raise ValueError(f"unsupported asset type: {path}")


# --- gltf + bary ------------------------------------------------------------

def load_gltf_bary(path: str, bary_path: str | None = None
                   ) -> mesh_mod.MicroMesh:
    g = gltf_mod.Gltf.load(path)
    positions = g.attribute("POSITION").astype(np.float32)
    normals = g.attribute("NORMAL").astype(np.float32)
    faces = g.indices().reshape(-1, 3).astype(np.int32)

    binding = g.displacement_micromap()
    if bary_path is None and binding is not None:
        bary_path = binding["bary_path"]
    if bary_path is None:
        # Fall back to a sibling .bary with the same stem.
        candidate = os.path.splitext(path)[0] + ".bary"
        if os.path.exists(candidate):
            bary_path = candidate
    if bary_path is None:
        raise ValueError(
            "gltf file does not reference micromesh data "
            "(no NV micromap extension and no sibling .bary)")
    content = bary_mod.read_bary(bary_path)

    # Displacement directions: extension accessor > dedicated attribute >
    # normals (the NV_displacement_micromap default when absent).
    if binding is not None and binding["directions"] is not None:
        directions = np.asarray(binding["directions"], np.float32
                                ).reshape(-1, 3).copy()
    else:
        try:
            directions = g.attribute("_DISPLACEMENT_DIRECTION"
                                     ).astype(np.float32)
        except KeyError:
            directions = normals.copy()

    # directionBounds (bias, scale) per base vertex fold into the base
    # position and the direction length: pos' = pos + dir*bias,
    # dir' = dir*scale, so displaced = pos' + value * dir'.
    if binding is not None and binding["direction_bounds"] is not None:
        bounds = np.asarray(binding["direction_bounds"], np.float32
                            ).reshape(-1, 2)
        positions = (positions + directions * bounds[:, :1]).astype(np.float32)
        directions = (directions * bounds[:, 1:2]).astype(np.float32)

    # Base triangle i -> bary triangle: group-relative mapIndices (plus
    # mapOffset) when given, else the identity mapping into the group.
    group_index = binding["group_index"] if binding is not None else 0
    if not content.groups:
        raise ValueError("bary file has no groups")
    if group_index >= len(content.groups):
        raise ValueError(f"groupIndex {group_index} out of range "
                         f"({len(content.groups)} bary groups)")
    group = content.groups[group_index]
    map_offset = binding["map_offset"] if binding is not None else 0
    if binding is not None and binding["map_indices"] is not None:
        rel = np.asarray(binding["map_indices"], np.int64).reshape(-1)
    else:
        if len(faces) != group.triangle_count:
            raise ValueError(
                f"gltf primitive has {len(faces)} triangles but bary group "
                f"{group_index} covers {group.triangle_count}")
        rel = np.arange(len(faces), dtype=np.int64)
    tri_map = group.triangle_first + rel + map_offset
    if tri_map.shape[0] != len(faces):
        raise ValueError("mapIndices length does not match gltf indices")
    if (tri_map < 0).any() or (tri_map >= len(content.tri_subdiv_level)).any():
        raise ValueError("micromap triangle mapping out of range")

    # Edge decimation flags: extension accessor > bary mesh property.
    if binding is not None and binding["primitive_flags"] is not None:
        flags = np.asarray(binding["primitive_flags"], np.uint8).reshape(-1)
    elif content.tri_edge_flags.shape[0] == len(content.tri_subdiv_level):
        flags = content.tri_edge_flags[tri_map]
    else:
        flags = np.zeros(len(faces), np.uint8)

    tris = []
    for i, f in enumerate(faces):
        t = int(tri_map[i])
        lvl = int(content.tri_subdiv_level[t])
        # triangle_scalars applies the owning group's bias/scale exactly once
        scales = content.triangle_scalars(t)
        tris.append(_assemble_triangle(
            f, lvl, scales, int(flags[i]), positions, directions))

    out = mesh_mod.MicroMesh(positions=positions, normals=normals,
                             directions=directions, triangles=tris)
    out.validate()
    return out


def _assemble_triangle(f, lvl, scales, edge_flags, positions, directions
                       ) -> mesh_mod.MicroTriangle:
    n = subdivision.rows_for_level(lvl)
    denom = max(n - 1, 1)
    coords = subdivision.grid_coords(lvl)
    u = coords[:, 0] / denom
    w = coords[:, 1] / denom
    bc = np.stack([1.0 - u, u - w, w], axis=1)
    v0, v1, v2 = positions[f[0]], positions[f[1]], positions[f[2]]
    d0, d1, d2 = directions[f[0]], directions[f[1]], directions[f[2]]
    u_pos = (bc[:, :1] * v0 + bc[:, 1:2] * v1 + bc[:, 2:3] * v2).astype(
        np.float32)
    interp_dir = (bc[:, :1] * d0 + bc[:, 1:2] * d1 + bc[:, 2:3] * d2).astype(
        np.float32)

    present = np.ones(coords.shape[0], dtype=bool)
    if n > 2:
        edge_verts = [
            (coords[:, 1] == 0, coords[:, 0]),               # v0-v1
            (coords[:, 0] == denom, coords[:, 1]),           # v1-v2
            (coords[:, 0] == coords[:, 1], coords[:, 0]),    # v2-v0
        ]
        for e, (on_edge, along) in enumerate(edge_verts):
            if edge_flags & (1 << e):
                present &= ~(on_edge & (along % 2 == 1))

    u_disp = np.where(present[:, None], scales[:, None] * interp_dir,
                      0.0).astype(np.float32)

    def present_at(c):
        return present[subdivision.grid_index(c)]

    _, corners = subdivision.enumerate_leaves(lvl, present_at)
    u_faces = subdivision.grid_index(corners).astype(np.int32)
    return mesh_mod.MicroTriangle(
        base_vertex_indices=np.asarray(f, np.int32),
        u_positions=u_pos, u_displacements=u_disp,
        u_present=present, u_faces=u_faces)


def save_gltf_bary(mesh: mesh_mod.MicroMesh, gltf_path: str,
                   bary_path: str | None = None,
                   container: str = "bary",
                   value_format: "bary_mod.Format | None" = None) -> None:
    """Write a MicroMesh as .gltf + .bary (round-trip capable).

    `container`: "bary" writes the spec-layout NVIDIA container (default;
    value_format eR32_sfloat unless given, eR11_unorm_packed_align32 stores
    min/range as the group bias/scale); "rtmb" writes the legacy minimal
    container.
    """
    from ..ops import precompute

    if bary_path is None:
        bary_path = os.path.splitext(gltf_path)[0] + ".bary"
    levels, flags, values, minmax = [], [], [], []
    for tri in mesh.triangles:
        lvl = tri.subdivision_level
        scales = precompute.displacement_scales(tri, mesh)
        # store u-major, with absent verts' scale forced to 0 (recovered via
        # edge flags on load)
        grid = np.where(tri.u_present, scales, 0.0).astype(np.float32)
        values.append(grid[bary_mod.grid_to_umajor_order(lvl)])
        levels.append(lvl)
        flags.append(_edge_flags_from_presence(tri))
        minmax.append((float(grid.min()), float(grid.max())))
    offsets = np.cumsum([0] + [len(v) for v in values[:-1]]).astype(np.int64)
    vals = np.concatenate(values).astype(np.float32)

    if container == "rtmb":
        content = bary_mod.BaryContent(
            groups=[bary_mod.BaryGroup(0, len(levels), 0, len(vals))],
            tri_value_offset=offsets,
            tri_subdiv_level=np.asarray(levels, np.int32),
            values=vals,
            tri_edge_flags=np.asarray(flags, np.uint8))
        bary_mod.write_rtmb(bary_path, content)
    elif container == "bary":
        fmt = value_format or bary_mod.Format.R32_SFLOAT
        bias, scale = 0.0, 1.0
        if fmt != bary_mod.Format.R32_SFLOAT:
            # unorm target: normalize into [0,1], recover via group bias/scale
            lo, hi = float(vals.min()), float(vals.max())
            bias, scale = lo, max(hi - lo, 1e-20)
            vals = ((vals - bias) / scale).astype(np.float32)
            minmax = [((a - bias) / scale, (b - bias) / scale)
                      for a, b in minmax]
        content = bary_mod.BaryContent(
            groups=[bary_mod.BaryGroup(
                0, len(levels), 0, len(vals), bias=bias, scale=scale,
                min_subdiv_level=int(min(levels)),
                max_subdiv_level=int(max(levels)))],
            tri_value_offset=offsets,
            tri_subdiv_level=np.asarray(levels, np.int32),
            values=vals,
            tri_edge_flags=np.asarray(flags, np.uint8),
            tri_min_max=np.asarray(minmax, np.float32))
        bary_mod.write_bary(bary_path, content, value_format=fmt)
    else:
        raise ValueError(f"unknown container {container!r}")

    gltf_mod.write_gltf(
        gltf_path, mesh.positions, mesh.normals,
        mesh.base_triangle_indices(),
        extra_root_ext={"NV_micromaps": {
            "micromaps": [{"uri": os.path.basename(bary_path)}]}},
        extra_prim_ext={"NV_displacement_micromap": {
            "micromap": 0, "groupIndex": 0}})


def _edge_flags_from_presence(tri: mesh_mod.MicroTriangle) -> int:
    n = tri.n_rows
    if n <= 2:
        return 0
    denom = n - 1
    coords = subdivision.grid_coords(tri.subdivision_level)
    specs = [
        (coords[:, 1] == 0, coords[:, 0]),
        (coords[:, 0] == denom, coords[:, 1]),
        (coords[:, 0] == coords[:, 1], coords[:, 0]),
    ]
    flags = 0
    for e, (on_edge, along) in enumerate(specs):
        odd = on_edge & (along % 2 == 1)
        if odd.any() and (~tri.u_present[subdivision.grid_index(
                coords[odd])]).all():
            flags |= 1 << e
    return flags


# --- umeshtools-style npz (SubdivisionMesh dump) ----------------------------

def load_npz(path: str) -> mesh_mod.MicroMesh:
    """Load an umeshtools-style SubdivisionMesh dump.

    Expected arrays (T = #base faces): `base_faces (T,3)`, `positions (V,3)`,
    `normals (V,3)`, per-face ragged data concatenated with offsets:
    `V (sumM,3)` micro positions, `VD (sumM,3)` micro displacements,
    `F (sumF,3)` micro faces (local indices), `v_offsets (T+1,)`,
    `f_offsets (T+1,)`, `base_V (T,3,3)`, `base_VD (T,3,3)`.

    This is the literal port of TinyGLTFLoader::toMesh
    (TinyGLTFLoader.cpp:26-105): presence = "referenced by a micro-face",
    per-vertex direction recovered by epsilon-matching positions against
    base_V (eps 1e-3, getVertexDisplacementDir).
    """
    z = np.load(path)
    base_faces = z["base_faces"].astype(np.int32)
    positions = z["positions"].astype(np.float32)
    normals = z["normals"].astype(np.float32)
    v_off = z["v_offsets"].astype(np.int64)
    f_off = z["f_offsets"].astype(np.int64)
    big_v = z["V"].astype(np.float32)
    big_vd = z["VD"].astype(np.float32)
    big_f = z["F"].astype(np.int64)
    base_v = z["base_V"].astype(np.float32)
    base_vd = z["base_VD"].astype(np.float32)

    # Per-vertex displacement direction by epsilon match
    # (TinyGLTFLoader.cpp:91-105).
    directions = np.zeros_like(positions)
    found = np.zeros(len(positions), bool)
    for t in range(len(base_faces)):
        for i in range(3):
            diff = np.abs(positions - base_v[t, i]).max(axis=1)
            hit = (diff <= 1e-3) & ~found
            directions[hit] = base_vd[t, i]
            found |= hit
    if not found.all():
        raise ValueError("Vertex displacement not found")  # cpp:104

    tris = []
    for t, f in enumerate(base_faces):
        vs = big_v[v_off[t]:v_off[t + 1]]
        vds = big_vd[v_off[t]:v_off[t + 1]]
        fs = big_f[f_off[t]:f_off[t + 1]].astype(np.int32)
        present = np.zeros(len(vs), bool)
        present[np.unique(fs)] = True                 # cpp:59-79
        tris.append(mesh_mod.MicroTriangle(
            base_vertex_indices=np.asarray(f, np.int32),
            u_positions=vs, u_displacements=vds,
            u_present=present, u_faces=fs))
    out = mesh_mod.MicroMesh(positions=positions, normals=normals,
                             directions=directions, triangles=tris)
    out.validate()
    return out


def save_npz(mesh: mesh_mod.MicroMesh, path: str) -> None:
    base_faces = mesh.base_triangle_indices()
    v_off = np.cumsum([0] + [t.u_positions.shape[0]
                             for t in mesh.triangles]).astype(np.int64)
    f_off = np.cumsum([0] + [t.u_faces.shape[0]
                             for t in mesh.triangles]).astype(np.int64)
    np.savez(
        path,
        base_faces=base_faces,
        positions=mesh.positions, normals=mesh.normals,
        V=np.concatenate([t.u_positions for t in mesh.triangles]),
        VD=np.concatenate([t.u_displacements for t in mesh.triangles]),
        F=np.concatenate([t.u_faces for t in mesh.triangles]),
        v_offsets=v_off, f_offsets=f_off,
        base_V=np.stack([mesh.positions[t.base_vertex_indices]
                         for t in mesh.triangles]),
        base_VD=np.stack([mesh.directions[t.base_vertex_indices]
                          for t in mesh.triangles]))
