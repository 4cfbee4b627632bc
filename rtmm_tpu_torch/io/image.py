"""Image output (PNG/BMP), dependency-free.

The reference has an stb-based Image + BMP writer
(framework/src/image.cpp:17-43, unused by the app) and
presents frames to a swapchain. Headless TPU hosts have no swapchain, so
frame output is a file: PNG via zlib (always available) plus the reference's
BMP format for parity.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 or float [0,1] image as PNG."""
    img = _to_u8(image)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_bmp(path: str, image: np.ndarray) -> None:
    """24-bit BMP, bottom-up BGR (matches image.cpp:17-43 output format)."""
    img = _to_u8(image)
    h, w, _ = img.shape
    row_pad = (4 - (w * 3) % 4) % 4
    body = b"".join(
        img[row, :, ::-1].tobytes() + b"\x00" * row_pad
        for row in range(h - 1, -1, -1))
    header = struct.pack("<2sIHHI", b"BM", 54 + len(body), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body),
                       2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + body)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own 8-bit RGB files (round-trip tests)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.int32)
    for row in range(h):
        line = raw[row * stride:(row + 1) * stride]
        filt, scan = line[0], np.frombuffer(line[1:], np.uint8).astype(np.int32)
        if filt == 0:
            cur = scan
        elif filt == 2:  # Up
            cur = (scan + prev) % 256
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        out[row] = cur.reshape(w, 3).astype(np.uint8)
        prev = cur
    return out


def _to_u8(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(img)
