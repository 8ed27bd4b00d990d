"""Minimal image IO (PNG via zlib, no external deps) + comparison metrics
(the port's own copy of the JAX package's utils/image.py)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3|4) float in [0,1] or uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit gray / RGB / RGBA, no interlace) for files
    such as write_png's; returns (H, W, C) uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "the data") -> np.ndarray:
    """Decode an in-memory PNG (8-bit gray / RGB / RGBA, no interlace) to
    (H, W, C) uint8: the resolver-chain path, where assets arrive as bytes
    with a canonical location (radient/resolver.py).  Raises ValueError on
    anything else."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{name} is not a PNG file")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color_type not in (0, 2, 6):
                raise ValueError(f"{name}: only 8-bit gray, RGB or RGBA")
            c = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, w, c), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)], np.uint8).copy()
        if ft == 0:
            pass
        elif ft == 1:  # sub
            for i in range(c, stride):
                line[i] = (int(line[i]) + int(line[i - c])) & 0xFF
        elif ft == 2:  # up
            line = (line + prev) & 0xFF
        elif ft == 3:  # average
            for i in range(stride):
                a = line[i - c] if i >= c else 0
                line[i] = (int(line[i])
                           + ((int(a) + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for i in range(stride):
                a = int(line[i - c]) if i >= c else 0
                b = int(prev[i])
                cc = int(prev[i - c]) if i >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (int(line[i]) + pr) & 0xFF
        out[y] = line.reshape(w, c)
        prev = line
    return out


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse <= 1e-20:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
