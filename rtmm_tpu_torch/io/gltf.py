"""Minimal glTF 2.0 reader/writer (pure Python, no tinygltf).

Covers the subset the reference uses (TinyGLTFLoader.cpp:26-57 via tinygltf):
.gltf (JSON + external/base64 buffers) and .glb, POSITION/NORMAL attributes
and the index accessor of mesh 0 / primitive 0, plus the micromap extension
hooks used by micromesh-tools assets.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class Gltf:
    def __init__(self, doc: dict, buffers: list[bytes], base_dir: str):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    @classmethod
    def load(cls, path: str) -> "Gltf":
        base_dir = os.path.dirname(os.path.abspath(path))
        if path.endswith(".glb"):
            with open(path, "rb") as f:
                data = f.read()
            magic, _version, _length = struct.unpack("<III", data[:12])
            if magic != 0x46546C67:
                raise ValueError("not a GLB file")
            pos, doc, bin_chunk = 12, None, b""
            while pos < len(data):
                clen, ctype = struct.unpack("<II", data[pos:pos + 8])
                payload = data[pos + 8:pos + 8 + clen]
                if ctype == 0x4E4F534A:
                    doc = json.loads(payload)
                elif ctype == 0x004E4942:
                    bin_chunk = payload
                pos += 8 + clen
            gltf = cls(doc, [], base_dir)
            gltf.buffers = [gltf._load_buffer(b, bin_chunk)
                            for b in doc.get("buffers", [])]
            return gltf
        with open(path) as f:
            doc = json.load(f)
        gltf = cls(doc, [], base_dir)
        gltf.buffers = [gltf._load_buffer(b, b"")
                        for b in doc.get("buffers", [])]
        return gltf

    def _load_buffer(self, buf: dict, bin_chunk: bytes) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            return bin_chunk
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.base_dir, uri), "rb") as f:
            return f.read()

    def accessor_data(self, index: int) -> np.ndarray:
        acc = self.doc["accessors"][index]
        view = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        dtype = COMPONENT_DTYPES[acc["componentType"]]
        ncomp = TYPE_COUNTS[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        count = acc["count"]
        stride = view.get("byteStride")
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            rows = [np.frombuffer(buf, dtype, ncomp, offset + i * stride)
                    for i in range(count)]
            out = np.stack(rows)
        else:
            out = np.frombuffer(buf, dtype, count * ncomp, offset)
        return out.reshape(count, ncomp) if ncomp > 1 else out

    def primitive(self, mesh_index: int = 0, prim_index: int = 0) -> dict:
        return self.doc["meshes"][mesh_index]["primitives"][prim_index]

    def attribute(self, name: str, mesh_index: int = 0,
                  prim_index: int = 0) -> np.ndarray:
        prim = self.primitive(mesh_index, prim_index)
        return self.accessor_data(prim["attributes"][name])

    def indices(self, mesh_index: int = 0, prim_index: int = 0) -> np.ndarray:
        prim = self.primitive(mesh_index, prim_index)
        return self.accessor_data(prim["indices"]).astype(np.uint32)

    def displacement_micromap(self, mesh_index: int = 0,
                              prim_index: int = 0) -> dict | None:
        """Parse the NV_displacement_micromap binding of one primitive.

        Spec shape (micromesh-tools / NV_micromaps vendor extension, consumed
        by the reference via umeshtools read_gltf —
        framework/src/TinyGLTFLoader.cpp:11-24, src/GPUMesh.cpp:145-148):
        the root `extensions.NV_micromaps.micromaps` array lists micromap
        files (uri or bufferView); each primitive's
        `extensions.NV_displacement_micromap` references one by `micromap`
        index plus `groupIndex` into the bary groups, with optional
        accessor-valued `directions` (vec3), `directionBounds` (vec2
        bias/scale per base vertex), `primitiveFlags` (u8 edge-decimation
        bits per base triangle), and `mapIndices`/`mapOffset` remapping base
        triangles to bary triangles.

        Returns None when the primitive carries no displacement micromap;
        otherwise a dict with resolved `bary_path`, `group_index`,
        `map_offset` ints and decoded accessor arrays (or None) for
        `map_indices`, `directions`, `direction_bounds`, `primitive_flags`.
        """
        prim = self.primitive(mesh_index, prim_index)
        dm = prim.get("extensions", {}).get("NV_displacement_micromap")
        if dm is None:
            return None
        root_ext = self.doc.get("extensions", {})
        # NV_micromaps is the primary list; NV_micromap_tooling carries
        # auxiliary files and must only be consulted as a fallback.
        maps = None
        for key in ("NV_micromaps", "NV_micromap_tooling"):
            maps = root_ext.get(key, {}).get("micromaps")
            if maps:
                break
        uri = None
        mi = int(dm.get("micromap", 0))
        if maps:
            if mi >= len(maps):
                raise ValueError(
                    f"NV_displacement_micromap references micromap {mi} "
                    f"but only {len(maps)} are defined")
            uri = maps[mi].get("uri")
        if uri is None:
            uri = dm.get("uri")  # legacy exporters inline the uri
        out = {
            "bary_path": (os.path.join(self.base_dir, uri)
                          if uri is not None else None),
            "group_index": int(dm.get("groupIndex", 0)),
            "map_offset": int(dm.get("mapOffset", 0)),
            "map_indices": None,
            "directions": None,
            "direction_bounds": None,
            "primitive_flags": None,
        }
        for key, name in (("mapIndices", "map_indices"),
                          ("directions", "directions"),
                          ("directionBounds", "direction_bounds"),
                          ("primitiveFlags", "primitive_flags")):
            if key in dm:
                out[name] = self.accessor_data(dm[key])
        return out

    def micromap_uri(self) -> str | None:
        """Resolve the .bary file referenced by an NV micromap extension, if
        any (legacy helper; prefer displacement_micromap())."""
        dm = self.displacement_micromap()
        if dm is not None and dm["bary_path"]:
            return dm["bary_path"]
        ext = self.doc.get("extensions", {})
        for key in ("NV_micromaps", "NV_micromap_tooling"):
            maps = ext.get(key, {}).get("micromaps")
            if maps:
                return os.path.join(self.base_dir, maps[0]["uri"])
        return None


def write_gltf(path: str, positions: np.ndarray, normals: np.ndarray,
               indices: np.ndarray, extra_root_ext: dict | None = None,
               extra_prim_ext: dict | None = None) -> None:
    """Write a minimal .gltf with an embedded base64 buffer."""
    positions = np.ascontiguousarray(positions, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32).reshape(-1)
    blob = positions.tobytes() + normals.tobytes() + indices.tobytes()
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": positions.nbytes},
        {"buffer": 0, "byteOffset": positions.nbytes,
         "byteLength": normals.nbytes},
        {"buffer": 0, "byteOffset": positions.nbytes + normals.nbytes,
         "byteLength": indices.nbytes},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(positions),
         "type": "VEC3",
         "min": positions.min(0).tolist(), "max": positions.max(0).tolist()},
        {"bufferView": 1, "componentType": 5126, "count": len(normals),
         "type": "VEC3"},
        {"bufferView": 2, "componentType": 5125, "count": len(indices),
         "type": "SCALAR"},
    ]
    prim = {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2}
    if extra_prim_ext:
        prim["extensions"] = extra_prim_ext
    doc = {
        "asset": {"version": "2.0", "generator": "rtmm-tpu"},
        "buffers": [{
            "byteLength": len(blob),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(blob).decode()}],
        "bufferViews": views,
        "accessors": accessors,
        "meshes": [{"primitives": [prim]}],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    used = sorted(set(extra_root_ext or ()) | set(extra_prim_ext or ()))
    if extra_root_ext:
        doc["extensions"] = extra_root_ext
    if used:
        doc["extensionsUsed"] = used
    with open(path, "w") as f:
        json.dump(doc, f)
