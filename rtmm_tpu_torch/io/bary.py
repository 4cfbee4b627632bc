"""`.bary` displacement-micromap container IO.

The reference delegates all .bary reading to the external `umeshtools_core`
library (framework/third_party/CMakeLists.txt:22-23, GPUMesh.cpp:143-152),
which yields per-face micro-vertex positions/displacements. We read the
container directly. Semantic content:

  * groups:    (triangle range, value range, float4 bias+scale, level range)
  * triangles: (value offset, subdivision level, block format)
  * values:    displacement scalars (several formats), u-major vertex order
  * optional:  per-triangle (min,max) displacement, per-triangle edge flags

Two containers are supported:

  1. The NVIDIA bary 1.0 container (Displacement-MicroMap-BaRy `bary_core`):
     a 16-byte version identifier, a table of properties identified by
     16-byte standardized UUIDs, and property payloads laid out as the
     spec's packed little-endian structs (`bary_Group` 56 B, `bary_Triangle`
     8 B, `bary_ValuesInfo` 24 B + data, `bary_TriangleMinMaxsInfo` 16 B +
     data). Value formats implemented: eR8_unorm, eR16_unorm, eR32_sfloat,
     eR11_unorm_pack16 and eR11_unorm_packed_align32 (11-bit LSB-first bit
     packing, per-triangle runs 4-byte aligned, offsets in bytes).

     PROVENANCE: this environment has no network egress and the spec
     headers are not mounted (the reference fetches micromesh-tools at
     build time), so the struct layouts are a reconstruction of the public
     `bary_types.h` and the standard-property UUIDs cannot be transcribed
     verbatim. The reader therefore (a) matches UUIDs against the table
     below, which can be corrected at runtime with
     `register_property_uuid(name, hex)`, and (b) if the version
     identifier matches but no property UUID is recognized, falls back to
     structural identification (payload sizes + info-header plausibility)
     with a warning — so a genuine micromesh-tools file still loads.

  2. `RTMB`, this framework's own minimal container (same semantic model,
     deterministic layout) used for caches and legacy round-trip tests.

Micro-vertex order: uncompressed displacement values are stored u-major on
the barycentric grid — index(u, v) sums full rows of decreasing length,
u along edge w0->w1, v along w0->w2. `umajor_to_grid_order` converts to this
framework's grid-storage order x*(x+1)/2 + y (intersection.hlsl:105-110) with
(u, v) = (x - y, y). The spec's alternative eTriangleBirdCurve vertex layout
is detected and rejected with a clear error (not produced by the
micromesh-tools displacement bakers this framework targets).
"""
from __future__ import annotations

import dataclasses
import enum
import struct
import uuid
import warnings

import numpy as np

from ..ops import subdivision

# 16-byte bary_VersionIdentifier (KTX-style guard bytes around "BARY 00100").
VERSION_IDENTIFIER = bytes([0xAB]) + b"BARY 00100" + bytes([0xBB]) + b"\r\n\x1a\n"
RTMB_MAGIC = b"RTMB\x01\x00"

_HEADER_FMT = "<16sQII"            # version, totalByteSize, preambleByteSize,
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)     # propertyInfoCount
_PROPINFO_FMT = "<16sQQIIQQ"       # identifier, range(off,len), scheme,
_PROPINFO_SIZE = struct.calcsize(_PROPINFO_FMT)  # reserved, global range
_GROUP_FMT = "<6I4f4f"             # bary_Group: ranges + float4 bias/scale
_GROUP_SIZE = struct.calcsize(_GROUP_FMT)        # = 56
_TRIANGLE_FMT = "<IHH"             # bary_Triangle: valuesOffset, level, block
_TRIANGLE_SIZE = struct.calcsize(_TRIANGLE_FMT)  # = 8
_VALUESINFO_FMT = "<6I"            # bary_ValuesInfo
_VALUESINFO_SIZE = struct.calcsize(_VALUESINFO_FMT)  # = 24
_MINMAXINFO_FMT = "<4I"            # bary_TriangleMinMaxsInfo
_MINMAXINFO_SIZE = struct.calcsize(_MINMAXINFO_FMT)  # = 16


class Format(enum.IntEnum):
    """bary_Format (uncompressed formats + DispC1 block compression)."""

    UNDEFINED = 0
    R8_UNORM = 1
    R8_SNORM = 2
    R8_UINT = 3
    R8_SINT = 4
    R16_UNORM = 5
    R16_SNORM = 6
    R16_UINT = 7
    R16_SINT = 8
    R32_UINT = 9
    R32_SINT = 10
    R32_SFLOAT = 11
    R64_UINT = 12
    R64_SINT = 13
    R64_SFLOAT = 14
    R11_UNORM_PACK16 = 15
    R11_UNORM_PACKED_ALIGN32 = 16
    # Block-compressed displacement (io/dispc1.py); per-triangle
    # blockFormat selects the DispC1 block layout. Enum value follows the
    # reconstruction pattern of this table (see module PROVENANCE note).
    DISPC1_R11_UNORM_BLOCK = 17


class ValueLayout(enum.IntEnum):
    UNDEFINED = 0
    TRIANGLE_UMAJOR = 1
    TRIANGLE_BIRD_CURVE = 2


class ValueFrequency(enum.IntEnum):
    UNDEFINED = 0
    PER_VERTEX = 1
    PER_TRIANGLE = 2


# Standard property identifiers. The spec keys properties by fixed 16-byte
# UUIDs; without the headers mounted we derive stable stand-ins (uuid5 in a
# fixed namespace) and accept corrections via register_property_uuid().
_UUID_NAMESPACE = uuid.uuid5(uuid.NAMESPACE_URL,
                             "https://github.com/NVIDIAGameWorks/"
                             "Displacement-MicroMap-BaRy")
STANDARD_PROPERTIES = (
    "values", "groups", "triangles", "triangle_min_maxs",
    "triangle_uncompressed_mips", "uncompressed_mips", "group_uncompressed_mips",
    "histogram_entries", "group_histogram_ranges",
    "mesh_groups", "mesh_histogram_entries", "mesh_group_histogram_ranges",
    "mesh_displacement_directions", "mesh_displacement_direction_bounds",
    "mesh_positions", "mesh_triangle_indices", "mesh_triangle_mappings",
    "mesh_triangle_flags",
)
PROPERTY_UUIDS: dict[str, bytes] = {
    name: uuid.uuid5(_UUID_NAMESPACE, name).bytes
    for name in STANDARD_PROPERTIES
}


def register_property_uuid(name: str, hex_or_bytes: str | bytes) -> None:
    """Override a standard property UUID (e.g. transcribed from bary_core)."""
    raw = bytes.fromhex(hex_or_bytes) if isinstance(hex_or_bytes, str) \
        else bytes(hex_or_bytes)
    if len(raw) != 16:
        raise ValueError("property identifiers are 16 bytes")
    PROPERTY_UUIDS[name] = raw


@dataclasses.dataclass
class BaryGroup:
    """bary_Group: a contiguous triangle+value range sharing bias/scale."""

    triangle_first: int
    triangle_count: int
    value_first: int          # element offset (bytes for packed formats)
    value_count: int
    bias: float = 0.0         # float4 in the container; displacement uses .r
    scale: float = 1.0
    min_subdiv_level: int = 0
    max_subdiv_level: int = 5


@dataclasses.dataclass
class BaryContent:
    """Decoded, format-normalized content of a displacement micromap.

    `values` holds float32 scalars: unorm formats are normalized to [0, 1],
    float formats kept raw; the group's bias/scale is NOT applied (use
    `triangle_scalars`). `tri_value_offset` is normalized to absolute element
    offsets into `values` regardless of the container's packing.
    """

    groups: list[BaryGroup]
    tri_value_offset: np.ndarray    # (T,) int64, absolute element offset
    tri_subdiv_level: np.ndarray    # (T,) int32
    values: np.ndarray              # (N,) float32 normalized scalars
    # Per-triangle edge decimation flags (bit e set = the neighbor across
    # edge e has one lower subdivision level, so the finest odd micro-verts
    # on that edge are absent). Edge order: 0 = v0v1, 1 = v1v2, 2 = v2v0.
    tri_edge_flags: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint8))
    tri_block_format: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint16))
    value_layout: int = int(ValueLayout.TRIANGLE_UMAJOR)
    value_frequency: int = int(ValueFrequency.PER_VERTEX)
    tri_min_max: np.ndarray | None = None    # (T, 2) float32, normalized

    def group_of_triangle(self, tri: int) -> BaryGroup:
        for g in self.groups:
            if g.triangle_first <= tri < g.triangle_first + g.triangle_count:
                return g
        raise IndexError(f"triangle {tri} not covered by any bary group")

    def triangle_values_grid_order(self, tri: int) -> np.ndarray:
        """Raw per-micro-vertex scalars of one triangle in grid order
        (no bias/scale)."""
        if self.value_layout != int(ValueLayout.TRIANGLE_UMAJOR):
            raise ValueError("only eTriangleUmajor value layout is supported")
        level = int(self.tri_subdiv_level[tri])
        count = subdivision.verts_for_level(level)
        off = int(self.tri_value_offset[tri])
        vals = self.values[off:off + count]
        return vals[umajor_to_grid_order(level)]

    def triangle_scalars(self, tri: int) -> np.ndarray:
        """Displacement scalars in grid order with the owning group's
        bias/scale applied: scalar = value * scale + bias."""
        g = self.group_of_triangle(tri)
        return (self.triangle_values_grid_order(tri) * np.float32(g.scale)
                + np.float32(g.bias)).astype(np.float32)


def umajor_index(u: np.ndarray, v: np.ndarray, segments: int) -> np.ndarray:
    """Linear index of micro-vertex (u, v) in u-major order; u+v <= segments."""
    n = segments + 1
    return u * n - (u * (u - 1)) // 2 + v


def umajor_to_grid_order(level: int) -> np.ndarray:
    """Permutation p with grid_vals = umajor_vals[p]."""
    coords = subdivision.grid_coords(level)          # storage order (x, y)
    s = 2**level
    u = coords[:, 0] - coords[:, 1]
    v = coords[:, 1]
    return umajor_index(u, v, s)


def grid_to_umajor_order(level: int) -> np.ndarray:
    p = umajor_to_grid_order(level)
    inv = np.empty_like(p)
    inv[p] = np.arange(p.shape[0])
    return inv


# --- 11-bit packing helpers --------------------------------------------------

def pack_r11(values_u11: np.ndarray) -> bytes:
    """Pack uint values (< 2048) as consecutive 11-bit fields, LSB-first."""
    v = np.asarray(values_u11, np.uint16)
    bits = np.zeros((v.shape[0], 11), np.uint8)
    for b in range(11):
        bits[:, b] = (v >> b) & 1
    flat = bits.reshape(-1)
    pad = (-flat.shape[0]) % 8
    flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    return np.packbits(flat, bitorder="little").tobytes()


def unpack_r11(data: bytes, count: int, bit_offset: int = 0) -> np.ndarray:
    """Unpack `count` consecutive 11-bit LSB-first values."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    need = bit_offset + count * 11
    if bits.shape[0] < need:
        raise ValueError("r11 value run exceeds property payload")
    sel = bits[bit_offset:need].reshape(count, 11).astype(np.uint16)
    out = np.zeros(count, np.uint16)
    for b in range(11):
        out |= sel[:, b] << b
    return out


_ELEMENT_DTYPES = {
    Format.R8_UNORM: (np.uint8, 255.0),
    Format.R16_UNORM: (np.uint16, 65535.0),
    Format.R32_SFLOAT: (np.float32, None),
    Format.R11_UNORM_PACK16: (np.uint16, 2047.0),
}


# --- RTMB container ----------------------------------------------------------

def write_rtmb(path: str, content: BaryContent) -> None:
    t = len(content.tri_value_offset)
    with open(path, "wb") as f:
        f.write(RTMB_MAGIC)
        f.write(struct.pack("<III", len(content.groups), t,
                            len(content.values)))
        for g in content.groups:
            f.write(struct.pack("<IIIIff", g.triangle_first, g.triangle_count,
                                g.value_first, g.value_count, g.bias, g.scale))
        f.write(np.asarray(content.tri_value_offset, "<i8").tobytes())
        f.write(np.asarray(content.tri_subdiv_level, "<i4").tobytes())
        flags = content.tri_edge_flags
        if flags.shape[0] != t:
            flags = np.zeros(t, np.uint8)
        f.write(np.asarray(flags, "u1").tobytes())
        f.write(np.asarray(content.values, "<f4").tobytes())


def read_rtmb(path: str) -> BaryContent:
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != RTMB_MAGIC:
        raise ValueError("not an RTMB file")
    ng, t, nv = struct.unpack_from("<III", data, 6)
    pos = 6 + 12
    groups = []
    for _ in range(ng):
        a, b, c, d, bias, scale = struct.unpack_from("<IIIIff", data, pos)
        groups.append(BaryGroup(a, b, c, d, bias, scale))
        pos += 24
    off = np.frombuffer(data, "<i8", t, pos); pos += 8 * t
    lvl = np.frombuffer(data, "<i4", t, pos); pos += 4 * t
    flags = np.frombuffer(data, "u1", t, pos); pos += t
    vals = np.frombuffer(data, "<f4", nv, pos)
    return BaryContent(groups, off.astype(np.int64), lvl.astype(np.int32),
                       vals.astype(np.float32), flags.astype(np.uint8))


# --- NVIDIA bary 1.0 container ----------------------------------------------

def write_bary(path: str, content: BaryContent,
               value_format: Format = Format.R32_SFLOAT) -> None:
    """Write a spec-layout NVIDIA bary container.

    `content.values` must be normalized scalars ([0,1] for unorm targets);
    group bias/scale is stored, not applied. `tri_value_offset` is in
    elements; the writer converts to the container's packing (bytes,
    4-aligned runs, for R11_UNORM_PACKED_ALIGN32).
    """
    n_tris = len(content.tri_value_offset)
    levels = np.asarray(content.tri_subdiv_level, np.int64)
    counts = np.array([subdivision.verts_for_level(int(l)) for l in levels],
                      np.int64)
    elem_offsets = np.asarray(content.tri_value_offset, np.int64)

    block_formats = np.zeros(n_tris, np.uint16)
    if value_format == Format.DISPC1_R11_UNORM_BLOCK:
        # Block-compressed: per-triangle DispC1 block runs (64/128-byte
        # blocks, naturally aligned). Values are quantized to 11-bit unorm
        # on the triangle's grid and encoded per io/dispc1.py; the chosen
        # block format lands in each bary_Triangle's blockFormat field.
        from . import dispc1
        blobs, tri_offsets = [], np.zeros(n_tris, np.int64)
        tri_end = np.zeros(n_tris, np.int64)
        pos = 0
        for t in range(n_tris):
            vals = content.values[elem_offsets[t]:elem_offsets[t] + counts[t]]
            q = np.clip(np.round(vals * 2047.0), 0, 2047).astype(np.int64)
            # Container order is u-major; the codec works in grid order.
            qg = q[umajor_to_grid_order(int(levels[t]))]
            blob, fmt_t = dispc1.encode_triangle(qg, int(levels[t]))
            block_formats[t] = int(fmt_t)
            tri_offsets[t] = pos
            blobs.append(blob)
            pos += len(blob)
            tri_end[t] = pos
        value_payload = b"".join(blobs)
        values_info = struct.pack(
            _VALUESINFO_FMT, int(value_format),
            content.value_layout, content.value_frequency,
            len(value_payload), 1, 64)  # count in bytes, byteSize 1
    elif value_format == Format.R11_UNORM_PACKED_ALIGN32:
        # Per-triangle 11-bit runs, each starting at a 4-byte aligned offset.
        blobs, tri_offsets = [], np.zeros(n_tris, np.int64)
        tri_end = np.zeros(n_tris, np.int64)
        pos = 0
        for t in range(n_tris):
            vals = content.values[elem_offsets[t]:elem_offsets[t] + counts[t]]
            q = np.clip(np.round(vals * 2047.0), 0, 2047).astype(np.uint16)
            blob = pack_r11(q)
            blob += b"\x00" * ((-len(blob)) % 4)
            tri_offsets[t] = pos
            blobs.append(blob)
            pos += len(blob)
            tri_end[t] = pos
        value_payload = b"".join(blobs)
        values_info = struct.pack(
            _VALUESINFO_FMT, int(value_format),
            content.value_layout, content.value_frequency,
            len(value_payload), 1, 4)   # count in bytes, byteSize 1, align 4
    else:
        dtype, denom = _ELEMENT_DTYPES[value_format]
        if denom is None:
            arr = np.asarray(content.values, "<f4")
        else:
            arr = np.clip(np.round(np.asarray(content.values) * denom),
                          0, denom).astype(dtype)
        value_payload = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        itemsize = np.dtype(dtype).itemsize
        values_info = struct.pack(
            _VALUESINFO_FMT, int(value_format),
            content.value_layout, content.value_frequency,
            len(content.values), itemsize, itemsize)
        tri_offsets = elem_offsets

    flags = content.tri_edge_flags
    if flags.shape[0] != n_tris:
        flags = np.zeros(n_tris, np.uint8)

    byte_packed = value_format in (Format.R11_UNORM_PACKED_ALIGN32,
                                   Format.DISPC1_R11_UNORM_BLOCK)
    props: list[tuple[str, bytes]] = []
    group_records = []
    for g in content.groups:
        if byte_packed:
            # value range in bytes: first triangle's byte offset .. last end
            last = g.triangle_first + g.triangle_count - 1
            vf = int(tri_offsets[g.triangle_first]) if g.triangle_count else 0
            vc = int(tri_end[last]) - vf if g.triangle_count else 0
        else:
            vf, vc = g.value_first, g.value_count
        group_records.append(struct.pack(
            _GROUP_FMT, g.triangle_first, g.triangle_count, vf, vc,
            g.min_subdiv_level, g.max_subdiv_level,
            g.bias, 0.0, 0.0, 0.0, g.scale, 1.0, 1.0, 1.0))
    props.append(("groups", b"".join(group_records)))

    tri_records = []
    for t in range(n_tris):
        # Offsets are group-relative in the container.
        g = content.group_of_triangle(t)
        if byte_packed:
            base = int(tri_offsets[g.triangle_first])
        else:
            base = g.value_first
        if value_format == Format.DISPC1_R11_UNORM_BLOCK:
            block = int(block_formats[t])
        else:
            block = int(content.tri_block_format[t]) \
                if content.tri_block_format.shape[0] == n_tris else 0
        tri_records.append(struct.pack(
            _TRIANGLE_FMT, int(tri_offsets[t]) - base, int(levels[t]), block))
    props.append(("triangles", b"".join(tri_records)))

    props.append(("values", values_info
                  + b"\x00" * ((-_VALUESINFO_SIZE) % 16) + value_payload))

    if content.tri_min_max is not None:
        mm = np.asarray(content.tri_min_max, "<f4").reshape(n_tris, 2)
        mm_info = struct.pack(_MINMAXINFO_FMT, int(Format.R32_SFLOAT),
                              2 * n_tris, 4, 4)
        props.append(("triangle_min_maxs", mm_info + mm.tobytes()))

    if flags.any():
        props.append(("mesh_triangle_flags", flags.tobytes()))

    preamble = _HEADER_SIZE + len(props) * _PROPINFO_SIZE
    offset = preamble
    infos, payloads = [], []
    for name, payload in props:
        offset += (-offset) % 16
        infos.append(struct.pack(_PROPINFO_FMT, PROPERTY_UUIDS[name],
                                 offset, len(payload), 0, 0, 0, 0))
        payloads.append((offset, payload))
        offset += len(payload)
    total = offset
    header = struct.pack(_HEADER_FMT, VERSION_IDENTIFIER, total, preamble,
                         len(props))
    out = bytearray(total)
    out[:_HEADER_SIZE] = header
    pos = _HEADER_SIZE
    for info in infos:
        out[pos:pos + _PROPINFO_SIZE] = info
        pos += _PROPINFO_SIZE
    for off, payload in payloads:
        out[off:off + len(payload)] = payload
    with open(path, "wb") as f:
        f.write(bytes(out))


_UUID_TO_NAME = None


def _identify_properties(raw_props: list[tuple[bytes, bytes]],
                         strict: bool = False) -> dict[str, bytes]:
    """Map raw (identifier, payload) pairs to property names.

    strict=True: every property identifier must match a registered UUID
    verbatim — an unrecognized identifier raises (with the full identifier
    list so it can be transcribed into register_property_uuid). Lenient
    (default): unrecognized identifiers fall back to structural
    identification by payload shape, with a warning NAMING each property
    that was matched structurally — a real micromesh-tools file still
    loads, and the operator can see exactly which matches to distrust.
    """
    global _UUID_TO_NAME
    _UUID_TO_NAME = {u: n for n, u in PROPERTY_UUIDS.items()}
    named = {}
    unknown = []
    for ident, payload in raw_props:
        name = _UUID_TO_NAME.get(bytes(ident))
        if name is not None:
            named[name] = payload
        else:
            unknown.append((ident, payload))
    if named or not unknown:
        return named
    if strict:
        raise ValueError(
            "strict bary parse: no property identifier matches a "
            "registered UUID. File identifiers: [%s]. This build's UUIDs "
            "are uuid5 stand-ins (see module PROVENANCE note); transcribe "
            "the real bary_core identifiers with "
            "rtmm_tpu_torch.io.bary.register_property_uuid(name, hex), or parse "
            "with strict=False for structural identification."
            % ", ".join(i.hex() for i, _ in unknown))
    # Structural fallback: a real micromesh-tools file whose UUIDs differ
    # from our reconstruction. Identify by payload shape.
    matched_structurally = []
    for ident, payload in unknown:
        if _looks_like_values(payload):
            if "values" not in named:
                named["values"] = payload
                matched_structurally.append(("values", ident))
        elif len(payload) % _GROUP_SIZE == 0 and _looks_like_groups(payload):
            if "groups" not in named:
                named["groups"] = payload
                matched_structurally.append(("groups", ident))
        elif len(payload) % _TRIANGLE_SIZE == 0 \
                and _looks_like_triangles(payload):
            if "triangles" not in named:
                named["triangles"] = payload
                matched_structurally.append(("triangles", ident))
        else:
            warnings.warn(
                f"ignoring unidentified bary property {ident.hex()} "
                f"({len(payload)} bytes)", stacklevel=3)
    if matched_structurally:
        warnings.warn(
            "bary property UUIDs unrecognized; matched STRUCTURALLY "
            "(distrust if the render looks wrong): %s. Register the true "
            "identifiers with rtmm_tpu_torch.io.bary.register_property_uuid, or "
            "pass strict=True to reject such files."
            % ", ".join(f"{n} <- {i.hex()}"
                        for n, i in matched_structurally),
            stacklevel=3)
    return named


def _looks_like_values(payload: bytes) -> bool:
    if len(payload) < _VALUESINFO_SIZE:
        return False
    fmt, layout, freq, count, bsize, align = struct.unpack_from(
        _VALUESINFO_FMT, payload, 0)
    try:
        Format(fmt)
    except ValueError:
        return False
    return (fmt != 0 and layout in (1, 2) and freq in (1, 2)
            and 0 < bsize <= 8 and count * bsize <= len(payload))


def _looks_like_groups(payload: bytes) -> bool:
    if not payload:
        return False
    ok = True
    for g in range(len(payload) // _GROUP_SIZE):
        rec = struct.unpack_from(_GROUP_FMT, payload, g * _GROUP_SIZE)
        ok &= rec[4] <= rec[5] <= 16      # plausible subdiv level range
    return ok


def _looks_like_triangles(payload: bytes) -> bool:
    if not payload:
        return False
    n = len(payload) // _TRIANGLE_SIZE
    arr = np.frombuffer(payload[:n * _TRIANGLE_SIZE], "<u4").reshape(n, 2)
    levels = arr[:, 1] & 0xFFFF
    return bool((levels <= 16).all())


def _strict_default() -> bool:
    import os
    return os.environ.get("RTMM_BARY_STRICT", "0") == "1"


def read_nvidia_bary(path: str, strict: bool | None = None) -> BaryContent:
    """Parse an NVIDIA bary 1.0 container.

    strict (default: RTMM_BARY_STRICT env, off): require verbatim property-
    UUID matches; reject structural identification. Every malformed-field
    error names the exact struct field (bary_Group[i].x / bary_Triangle[t].x)
    so a genuine file's first failure is diagnosable from the message +
    rtmm_tpu/io/FORMATS.md alone.
    """
    if strict is None:
        strict = _strict_default()
    with open(path, "rb") as f:
        data = f.read()
    if data[:5] != VERSION_IDENTIFIER[:5]:
        raise ValueError(
            "not an NVIDIA bary container (bad version identifier); "
            "convert with micromesh-tools or use RTMB")
    if data[:16] != VERSION_IDENTIFIER:
        warnings.warn("bary version identifier differs from 1.0 "
                      "(%s); attempting to parse anyway" % data[:16].hex(),
                      stacklevel=2)
    _version, total, _preamble, prop_count = struct.unpack_from(
        _HEADER_FMT, data, 0)
    if total != len(data):
        warnings.warn("bary totalByteSize %d != file size %d"
                      % (total, len(data)), stacklevel=2)
    raw_props = []
    pos = _HEADER_SIZE
    for _ in range(prop_count):
        ident, off, length, scheme, _res, _goff, _glen = struct.unpack_from(
            _PROPINFO_FMT, data, pos)
        if scheme != 0:
            raise ValueError("supercompressed bary properties unsupported")
        if off + length > len(data):
            raise ValueError(
                "bary propertyInfo[%d].byteRange (offset=%d, length=%d) "
                "exceeds the file size %d"
                % (len(raw_props), off, length, len(data)))
        raw_props.append((ident, data[off:off + length]))
        pos += _PROPINFO_SIZE
    props = _identify_properties(raw_props, strict=strict)
    if "triangles" not in props or "values" not in props:
        raise ValueError(
            "bary file missing triangle/value properties (found: %s)"
            % (sorted(props) or "none"))

    tri_raw = props["triangles"]
    n_tris = len(tri_raw) // _TRIANGLE_SIZE
    tri_u32 = np.frombuffer(tri_raw[:n_tris * _TRIANGLE_SIZE], "<u4"
                            ).reshape(n_tris, 2)
    tri_rel_offset = tri_u32[:, 0].astype(np.int64)
    tri_subdiv = (tri_u32[:, 1] & 0xFFFF).astype(np.int32)
    tri_block = (tri_u32[:, 1] >> 16).astype(np.uint16)
    bad = np.nonzero(tri_subdiv > 16)[0]
    if bad.size:
        raise ValueError(
            "bary_Triangle[%d].subdivLevel = %d out of range (0..16); the "
            "triangles property is corrupt or misidentified"
            % (int(bad[0]), int(tri_subdiv[bad[0]])))

    vfmt, layout, freq, vcount, vbsize, _valign = struct.unpack_from(
        _VALUESINFO_FMT, props["values"], 0)
    payload = props["values"][_VALUESINFO_SIZE + ((-_VALUESINFO_SIZE) % 16):]
    fmt = Format(vfmt)
    if layout == int(ValueLayout.TRIANGLE_BIRD_CURVE):
        raise ValueError("eTriangleBirdCurve value layout unsupported "
                         "(re-bake with uMajor layout)")

    groups = []
    if "groups" in props:
        graw = props["groups"]
        for g in range(len(graw) // _GROUP_SIZE):
            rec = struct.unpack_from(_GROUP_FMT, graw, g * _GROUP_SIZE)
            if rec[0] + rec[1] > n_tris:
                raise ValueError(
                    "bary_Group[%d].triangleFirst+triangleCount = %d+%d "
                    "exceeds the triangle count %d"
                    % (g, rec[0], rec[1], n_tris))
            if rec[4] > rec[5] or rec[5] > 16:
                raise ValueError(
                    "bary_Group[%d].minSubdivLevel..maxSubdivLevel = "
                    "%d..%d is not a valid level range (0..16)"
                    % (g, rec[4], rec[5]))
            groups.append(BaryGroup(
                triangle_first=rec[0], triangle_count=rec[1],
                value_first=rec[2], value_count=rec[3],
                min_subdiv_level=rec[4], max_subdiv_level=rec[5],
                bias=rec[6], scale=rec[10]))
    else:
        groups.append(BaryGroup(0, n_tris, 0, vcount))

    counts = np.array([subdivision.verts_for_level(int(l))
                       for l in tri_subdiv], np.int64)

    if fmt == Format.DISPC1_R11_UNORM_BLOCK:
        # Block-compressed: decode every triangle's DispC1 blocks to
        # normalized per-vertex scalars (container order is u-major, the
        # codec's grid order is converted back).
        from . import dispc1
        values_list, abs_offsets = [], np.zeros(n_tris, np.int64)
        pos = 0
        for g in groups:
            for t in range(g.triangle_first,
                           g.triangle_first + g.triangle_count):
                lvl = int(tri_subdiv[t])
                try:
                    bf = dispc1.BlockFormatDispC1(int(tri_block[t]))
                except ValueError:
                    raise ValueError(
                        "bary_Triangle[%d].blockFormat = %d is not a "
                        "known bary_BlockFormatDispC1 (1..3)"
                        % (t, int(tri_block[t])))
                byte_off = g.value_first + tri_rel_offset[t]
                nbytes = dispc1.triangle_block_bytes(lvl, bf)
                if byte_off + nbytes > len(payload):
                    raise ValueError(
                        "bary_Triangle[%d].valuesOffset = %d: %d-byte "
                        "%s block run exceeds the values payload "
                        "(%d bytes)" % (t, int(tri_rel_offset[t]),
                                        nbytes, bf.name, len(payload)))
                qg = dispc1.decode_triangle(
                    payload[byte_off:byte_off + nbytes], lvl, bf)
                q = qg[grid_to_umajor_order(lvl)]
                values_list.append(q.astype(np.float32) / 2047.0)
                abs_offsets[t] = pos
                pos += counts[t]
        values = (np.concatenate(values_list) if values_list
                  else np.zeros(0, np.float32))
        tri_abs = abs_offsets
        pos = 0
        for g in groups:
            n = int(counts[g.triangle_first:
                           g.triangle_first + g.triangle_count].sum())
            g.value_first, g.value_count = pos, n
            pos += n
    elif fmt == Format.R11_UNORM_PACKED_ALIGN32:
        # Offsets are bytes relative to the group's byte range.
        values_list, abs_offsets = [], np.zeros(n_tris, np.int64)
        pos = 0
        for g in groups:
            for t in range(g.triangle_first,
                           g.triangle_first + g.triangle_count):
                byte_off = g.value_first + tri_rel_offset[t]
                try:
                    q = unpack_r11(payload[byte_off:], int(counts[t]))
                except ValueError:
                    raise ValueError(
                        "bary_Triangle[%d].valuesOffset = %d: %d-value "
                        "r11 run exceeds the values payload (%d bytes)"
                        % (t, int(tri_rel_offset[t]), int(counts[t]),
                           len(payload)))
                values_list.append(q.astype(np.float32) / 2047.0)
                abs_offsets[t] = pos
                pos += counts[t]
        values = (np.concatenate(values_list) if values_list
                  else np.zeros(0, np.float32))
        tri_abs = abs_offsets
        # group value ranges now refer to the decoded element array
        pos = 0
        for g in groups:
            n = int(counts[g.triangle_first:
                           g.triangle_first + g.triangle_count].sum())
            g.value_first, g.value_count = pos, n
            pos += n
    else:
        try:
            dtype, denom = _ELEMENT_DTYPES[fmt]
        except KeyError:
            raise ValueError(f"unsupported bary value format {fmt.name}")
        itemsize = np.dtype(dtype).itemsize
        if vbsize != itemsize:
            warnings.warn("bary valueByteSize %d != format size %d"
                          % (vbsize, itemsize), stacklevel=2)
        arr = np.frombuffer(payload, np.dtype(dtype).newbyteorder("<"),
                            vcount)
        if fmt == Format.R11_UNORM_PACK16:
            arr = arr & 0x7FF
        values = arr.astype(np.float32)
        if denom is not None:
            values = values / np.float32(denom)
        tri_abs = np.zeros(n_tris, np.int64)
        for g in groups:
            tsel = np.arange(g.triangle_first,
                             g.triangle_first + g.triangle_count)
            tri_abs[tsel] = g.value_first + tri_rel_offset[tsel]
        bad = np.nonzero(tri_abs + counts > values.shape[0])[0]
        if bad.size:
            t = int(bad[0])
            raise ValueError(
                "bary_Triangle[%d].valuesOffset = %d: %d-element value "
                "run exceeds the decoded value count %d"
                % (t, int(tri_rel_offset[t]), int(counts[t]),
                   values.shape[0]))

    flags = np.zeros(n_tris, np.uint8)
    if "mesh_triangle_flags" in props:
        fl = np.frombuffer(props["mesh_triangle_flags"], np.uint8)
        flags[:min(n_tris, fl.shape[0])] = fl[:n_tris]

    tri_min_max = None
    if "triangle_min_maxs" in props:
        mm_raw = props["triangle_min_maxs"]
        mfmt, mcount, msize, _malign = struct.unpack_from(
            _MINMAXINFO_FMT, mm_raw, 0)
        mdata = mm_raw[_MINMAXINFO_SIZE:]
        if Format(mfmt) == Format.R32_SFLOAT:
            tri_min_max = np.frombuffer(mdata, "<f4", mcount).reshape(-1, 2)
        elif Format(mfmt) in _ELEMENT_DTYPES:
            dt, dn = _ELEMENT_DTYPES[Format(mfmt)]
            raw = np.frombuffer(mdata, np.dtype(dt).newbyteorder("<"), mcount)
            tri_min_max = (raw.astype(np.float32) / np.float32(dn)
                           ).reshape(-1, 2)

    return BaryContent(groups, tri_abs, tri_subdiv,
                       values.astype(np.float32), flags, tri_block,
                       value_layout=layout, value_frequency=freq,
                       tri_min_max=tri_min_max)


def dump_bary(path: str) -> str:
    """Human-readable inspection of a .bary container (CLI: --dump-bary).

    Best-effort: prints every header/property field it can parse even when
    later validation would reject the file, so a genuine micromesh-tools
    file's first mismatch against this reader's reconstructed layout
    (module PROVENANCE note; field layouts documented in
    rtmm_tpu/io/FORMATS.md) is diagnosable from this dump alone.
    """
    with open(path, "rb") as f:
        data = f.read()
    lines = [f"file: {path} ({len(data)} bytes)"]
    if data[:6] == RTMB_MAGIC:
        lines.append("container: RTMB (this framework's native cache format)")
        c = read_rtmb(path)
        lines.append(f"groups: {len(c.groups)}  triangles: "
                     f"{len(c.tri_value_offset)}  values: {len(c.values)}")
        return "\n".join(lines)
    ver = data[:16]
    lines.append(f"versionIdentifier: {ver.hex()}"
                 + ("  (bary 1.0)" if ver == VERSION_IDENTIFIER
                    else "  (MISMATCH vs bary 1.0 "
                         f"{VERSION_IDENTIFIER.hex()})"))
    if len(data) < _HEADER_SIZE:
        lines.append("file shorter than the 32-byte header; cannot parse")
        return "\n".join(lines)
    _v, total, preamble, prop_count = struct.unpack_from(_HEADER_FMT, data, 0)
    lines.append(f"totalByteSize: {total}"
                 + ("" if total == len(data) else
                    f"  (MISMATCH: file is {len(data)})"))
    lines.append(f"preambleByteSize: {preamble}  propertyInfoCount: "
                 f"{prop_count}")
    name_of = {u: n for n, u in PROPERTY_UUIDS.items()}
    pos = _HEADER_SIZE
    for i in range(prop_count):
        if pos + _PROPINFO_SIZE > len(data):
            lines.append(f"propertyInfo[{i}]: truncated")
            break
        ident, off, length, scheme, _res, goff, glen = struct.unpack_from(
            _PROPINFO_FMT, data, pos)
        pos += _PROPINFO_SIZE
        name = name_of.get(bytes(ident))
        if name is None:
            payload = data[off:off + length]
            if _looks_like_values(payload):
                name = "UNKNOWN uuid (structurally: values)"
            elif length % _GROUP_SIZE == 0 and _looks_like_groups(payload):
                name = "UNKNOWN uuid (structurally: groups)"
            elif length % _TRIANGLE_SIZE == 0 \
                    and _looks_like_triangles(payload):
                name = "UNKNOWN uuid (structurally: triangles)"
            else:
                name = "UNKNOWN uuid"
        lines.append(f"propertyInfo[{i}]: {ident.hex()}  {name}")
        lines.append(f"  byteRange: offset={off} length={length} "
                     f"scheme={scheme} uncompressed=({goff},{glen})"
                     + ("" if off + length <= len(data)
                        else "  (EXCEEDS FILE)"))
        if name == "groups" and length % _GROUP_SIZE == 0:
            for g in range(length // _GROUP_SIZE):
                rec = struct.unpack_from(_GROUP_FMT, data,
                                         off + g * _GROUP_SIZE)
                lines.append(
                    f"  group[{g}]: triangles [{rec[0]}, {rec[0]+rec[1]})"
                    f"  values [{rec[2]}, {rec[2]+rec[3]})  levels "
                    f"{rec[4]}..{rec[5]}  bias={rec[6]:g} scale={rec[10]:g}")
        elif name == "triangles" and length % _TRIANGLE_SIZE == 0:
            n = length // _TRIANGLE_SIZE
            arr = np.frombuffer(data[off:off + n * _TRIANGLE_SIZE],
                                "<u4").reshape(n, 2)
            levels = arr[:, 1] & 0xFFFF
            blocks = arr[:, 1] >> 16
            hist = {int(l): int((levels == l).sum())
                    for l in np.unique(levels)}
            lines.append(f"  triangles: {n}  level histogram: {hist}"
                         f"  blockFormats: "
                         f"{sorted(int(b) for b in np.unique(blocks))}")
        elif name == "values" and length >= _VALUESINFO_SIZE:
            fmt, layout, freq, count, bsize, align = struct.unpack_from(
                _VALUESINFO_FMT, data, off)
            try:
                fname = Format(fmt).name
            except ValueError:
                fname = f"UNKNOWN({fmt})"
            lines.append(
                f"  valuesInfo: format={fname} layout="
                f"{ValueLayout(layout).name if layout in (0, 1, 2) else layout}"
                f" frequency={freq} count={count} byteSize={bsize}"
                f" byteAlignment={align}")
        elif name == "triangle_min_maxs" and length >= _MINMAXINFO_SIZE:
            mfmt, mcount, msize, malign = struct.unpack_from(
                _MINMAXINFO_FMT, data, off)
            try:
                fname = Format(mfmt).name
            except ValueError:
                fname = f"UNKNOWN({mfmt})"
            lines.append(f"  minMaxsInfo: format={fname} count={mcount} "
                         f"byteSize={msize} byteAlignment={malign}")
    return "\n".join(lines)


def read_bary(path: str, strict: bool | None = None) -> BaryContent:
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:6] == RTMB_MAGIC:
        return read_rtmb(path)
    return read_nvidia_bary(path, strict=strict)
