"""DispC1 (`eDispC1_r11_unorm_block`) block-compressed displacement codec.

Real micromesh-tools bakes commonly emit block-compressed displacement
(the reference consumes it through umeshtools_core,
framework/third_party/CMakeLists.txt:22-23); round 2 of
this framework rejected such files outright. This module implements the
DispC1 scheme: fixed-size blocks holding 11-bit UNORM displacement for
one subdivision subtree, encoded as three 11-bit anchor values plus
per-level *prediction corrections* of decreasing bit width with a
per-level shift — decode is

    value(new vertex at level l) =
        (mean(decoded endpoints of its parent edge)
         + sign_extend(correction) << shift[l]) mod 2048

PROVENANCE: no network egress and no spec headers are mounted, so the
exact bit widths/offsets are a reconstruction of the public
Displacement-MicroMap-BaRy block formats; the prediction/correction/shift
scheme and the three block formats (lvl3 in 512 bits, lvl4/lvl5 in 1024)
match the published description. All layout decisions live in the
`_LAYOUTS` table below so a correction against the real headers is a
constant edit; the encoder and decoder share the table, and the e2e
oracle (tests/test_io.py) guarantees self-consistency: write(quantize) ->
read -> render == tessellated render of the decoded values.

Encoding is exact (shift 0) whenever every correction fits its level
width; otherwise the encoder raises the shift per level until the worst
correction fits (lossy, like the real baker's rate control). The
lvl3_pack512 format dedicates 11 bits to every level, so any level-3
field round-trips losslessly.
"""
from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np

from ..ops import subdivision


class BlockFormatDispC1(enum.IntEnum):
    """bary_BlockFormatDispC1 (per-triangle `blockFormat` field)."""

    INVALID = 0
    R11_UNORM_LVL3_PACK512 = 1     # one level-3 subtree in 64 bytes
    R11_UNORM_LVL4_PACK1024 = 2    # one level-4 subtree in 128 bytes
    R11_UNORM_LVL5_PACK1024 = 3    # one level-5 subtree in 128 bytes


@dataclasses.dataclass(frozen=True)
class _Layout:
    level: int                     # subtree subdivision level of one block
    block_bytes: int
    # Per hierarchy level 1..level: correction bit width for the vertices
    # introduced at that level (anchors are level 0, always 11 bits).
    widths: tuple[int, ...]
    # Bits for each level's shift field (shift raises lossy range).
    shift_bits: tuple[int, ...]


_LAYOUTS: dict[BlockFormatDispC1, _Layout] = {
    # 45 verts x 11 bits = 495 <= 512: effectively uncompressed, lossless.
    BlockFormatDispC1.R11_UNORM_LVL3_PACK512:
        _Layout(3, 64, (11, 11, 11), (0, 0, 0)),
    # 153 verts: 33 + 3x11 + 9x11 + 30x8 + 108x4 = 837 bits + shifts.
    BlockFormatDispC1.R11_UNORM_LVL4_PACK1024:
        _Layout(4, 128, (11, 11, 8, 4), (0, 4, 4, 4)),
    # 561 verts: 33 + 3x11 + 9x8 + 30x4 + 108x2 + 408x1 = 882 + shifts.
    BlockFormatDispC1.R11_UNORM_LVL5_PACK1024:
        _Layout(5, 128, (11, 8, 4, 2, 1), (0, 4, 4, 4, 4)),
}

FORMAT_FOR_LEVEL = {
    3: BlockFormatDispC1.R11_UNORM_LVL3_PACK512,
    4: BlockFormatDispC1.R11_UNORM_LVL4_PACK1024,
    5: BlockFormatDispC1.R11_UNORM_LVL5_PACK1024,
}


@functools.cache
def _level_order(level: int):
    """Vertex decode schedule for one level-`level` subtree grid.

    Returns (anchors (3,) grid indices, per-level lists of
    (vertex_grid_idx, parent_a_grid_idx, parent_b_grid_idx) arrays).
    Grid indices are this framework's storage order x*(x+1)/2 + y; within
    each level, vertices are emitted in u-major order of their coords
    (the container's value ordering convention).
    """
    anchors = subdivision.grid_index(subdivision.root_corners(level))
    per_level = []
    for l in range(1, level + 1):
        step = 2 ** (level - l)              # finest-grid units of level l
        prev = 2 * step
        coords = subdivision.grid_coords(level)      # (M, 2) finest units
        on_l = ((coords[:, 0] % step == 0) & (coords[:, 1] % step == 0))
        on_prev = ((coords[:, 0] % prev == 0) & (coords[:, 1] % prev == 0))
        new = np.nonzero(on_l & ~on_prev)[0]
        x, y = coords[new, 0], coords[new, 1]
        xo = (x // step) % 2 == 1
        yo = (y // step) % 2 == 1
        # Parent edge endpoints on the level-(l-1) grid: midpoints lie on
        # one of the three triangular edge directions.
        pa = np.where(xo & ~yo, subdivision.grid_index(
                          np.stack([x - step, y], -1)),
             np.where(~xo & yo, subdivision.grid_index(
                          np.stack([x, y - step], -1)),
                      subdivision.grid_index(
                          np.stack([x - step, y - step], -1))))
        pb = np.where(xo & ~yo, subdivision.grid_index(
                          np.stack([x + step, y], -1)),
             np.where(~xo & yo, subdivision.grid_index(
                          np.stack([x, y + step], -1)),
                      subdivision.grid_index(
                          np.stack([x + step, y + step], -1))))
        # u-major order within the level: sort by (u, v) = (x - y, y).
        order = np.lexsort((y, x - y))
        per_level.append((subdivision.grid_index(
            np.stack([x, y], -1))[order], pa[order], pb[order]))
    return anchors, per_level


class _BitWriter:
    def __init__(self, nbytes: int):
        self.bits = np.zeros(nbytes * 8, np.uint8)
        self.pos = 0

    def put(self, value: int, width: int):
        v = int(value) & ((1 << width) - 1)
        for b in range(width):
            self.bits[self.pos + b] = (v >> b) & 1
        self.pos += width
        if self.pos > self.bits.shape[0]:
            raise ValueError("DispC1 block overflow (layout table bug)")

    def tobytes(self) -> bytes:
        return np.packbits(self.bits, bitorder="little").tobytes()


class _BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8),
                                  bitorder="little")
        self.pos = 0

    def get(self, width: int) -> int:
        v = 0
        for b in range(width):
            v |= int(self.bits[self.pos + b]) << b
        self.pos += width
        return v


def _sext(value: int, width: int) -> int:
    """Sign-extend a width-bit field."""
    sign = 1 << (width - 1)
    return (value ^ sign) - sign


def encode_block(values_grid: np.ndarray, fmt: BlockFormatDispC1) -> bytes:
    """Encode one subtree's 11-bit values (grid-storage order) to a block.

    values_grid: (verts_for_level(layout.level),) uint in [0, 2048).
    Per level, the smallest shift that fits every correction is chosen;
    shift 0 round-trips losslessly.
    """
    lay = _LAYOUTS[fmt]
    anchors, per_level = _level_order(lay.level)
    vals = np.asarray(values_grid, np.int64)
    if vals.shape[0] != subdivision.verts_for_level(lay.level):
        raise ValueError(
            f"{fmt.name} encodes {subdivision.verts_for_level(lay.level)} "
            f"values, got {vals.shape[0]}")
    decoded = np.zeros_like(vals)
    w = _BitWriter(lay.block_bytes)
    for a in anchors:
        w.put(int(vals[a]), 11)
        decoded[a] = vals[a]
    shifts = []
    level_corrs = []
    for (vidx, pa, pb), width, sbits in zip(per_level, lay.widths,
                                            lay.shift_bits):
        pred = (decoded[pa] + decoded[pb]) >> 1
        delta = (vals[vidx] - pred) & 2047
        # Corrections are signed mod-2048 residuals: map to [-1024, 1024).
        sdelta = np.where(delta >= 1024, delta - 2048, delta)
        shift = 0
        max_shift = (1 << sbits) - 1 if sbits else 0
        lo, hi = -(1 << (width - 1)), (1 << (width - 1)) - 1
        while shift < max_shift and (
                ((sdelta + (1 << shift) // 2) >> shift < lo)
                | ((sdelta + (1 << shift) // 2) >> shift > hi)).any():
            shift += 1
        corr = np.clip((sdelta + (1 << shift) // 2) >> shift, lo, hi)
        decoded[vidx] = (pred + (corr << shift)) & 2047
        shifts.append(shift)
        level_corrs.append(corr)
    for shift, sbits in zip(shifts, lay.shift_bits):
        if sbits:
            w.put(shift, sbits)
    for corr, width in zip(level_corrs, lay.widths):
        for c in corr:
            w.put(int(c), width)
    return w.tobytes()


def decode_block(data: bytes, fmt: BlockFormatDispC1) -> np.ndarray:
    """Decode one block to 11-bit values in grid-storage order."""
    lay = _LAYOUTS[fmt]
    anchors, per_level = _level_order(lay.level)
    out = np.zeros(subdivision.verts_for_level(lay.level), np.int64)
    r = _BitReader(data[:lay.block_bytes])
    for a in anchors:
        out[a] = r.get(11)
    shifts = [r.get(sbits) if sbits else 0 for sbits in lay.shift_bits]
    for (vidx, pa, pb), width, shift in zip(per_level, lay.widths, shifts):
        pred = (out[pa] + out[pb]) >> 1
        corr = np.array([_sext(r.get(width), width) for _ in vidx],
                        np.int64)
        out[vidx] = (pred + (corr << shift)) & 2047
    return out


def encode_triangle(values_grid: np.ndarray, level: int,
                    force_lvl3_split: bool = False
                    ) -> tuple[bytes, BlockFormatDispC1]:
    """Encode one triangle's displacement grid (storage order, uint11).

    Levels 3-5 encode as ONE block of the matching format; levels < 3 are
    not block-compressed by the bakers this targets (use an uncompressed
    bary format). force_lvl3_split=True instead splits a level-4/5
    triangle into 4^(L-3) level-3 blocks (one per level-(L-3) subtree, in
    hierarchical slot order) — the multi-block layout the decoder also
    accepts; lossless for any field.
    """
    if level < 3:
        raise ValueError("DispC1 block formats start at subdivision level 3 "
                         "(bake shallower triangles uncompressed)")
    if level > 5:
        raise ValueError("subdivision level > 5 unsupported (reference max, "
                         "intersection.hlsl:79)")
    vals = np.asarray(values_grid, np.int64)
    if not force_lvl3_split or level == 3:
        fmt = FORMAT_FOR_LEVEL[level]
        return encode_block(vals, fmt), fmt
    fmt = BlockFormatDispC1.R11_UNORM_LVL3_PACK512
    from ..ops import compressed as comp
    gcoords, su = comp.subtree_grid_coords(level)        # (spt, 45, 2)
    assert su == 3
    blocks = []
    for s in range(gcoords.shape[0]):
        sub_vals = vals[subdivision.grid_index(gcoords[s])]
        blocks.append(encode_block(sub_vals, fmt))
    return b"".join(blocks), fmt


def decode_triangle(data: bytes, level: int, fmt: BlockFormatDispC1
                    ) -> np.ndarray:
    """Decode one triangle's blocks back to grid-storage-order uint11.

    Accepts both the single matching-level block and the split layout
    (4^(L-3) level-3 blocks in hierarchical subtree slot order).
    """
    lay = _LAYOUTS[fmt]
    if lay.level == level:
        return decode_block(data, fmt)
    if lay.level > level:
        raise ValueError(f"{fmt.name} block exceeds triangle level {level}")
    if lay.level != 3:
        raise ValueError("split encoding uses level-3 blocks")
    from ..ops import compressed as comp
    gcoords, su = comp.subtree_grid_coords(level)
    out = np.zeros(subdivision.verts_for_level(level), np.int64)
    for s in range(gcoords.shape[0]):
        block = data[s * lay.block_bytes:(s + 1) * lay.block_bytes]
        out[subdivision.grid_index(gcoords[s])] = decode_block(block, fmt)
    return out


def triangle_block_bytes(level: int, fmt: BlockFormatDispC1) -> int:
    lay = _LAYOUTS[fmt]
    if lay.level == level:
        return lay.block_bytes
    return lay.block_bytes * 4 ** (level - lay.level)
