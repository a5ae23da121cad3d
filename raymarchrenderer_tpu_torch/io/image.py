"""Image output: linear float accumulation -> sRGB BMP/PNG, or float NPY.

The reference saves its accumulation buffer as an sRGB-encoded BMP
(`Graphics::SaveImage`, `Graphics.cpp:754-799`) named
"%Y-%m-%d_%H-%M-%S.bmp" (`Program.cpp:71-84`).  The buffer stays float32
linear and ONE explicit sRGB OETF applies at encode time.  These are the
JAX package's pure-Python encoders (24-bit bottom-up BGR BMP, zlib PNG),
byte for byte; the native C++ encoder is not bound here.  Images are numpy
arrays: callers hand over `tensor.cpu().numpy()`.
"""
from __future__ import annotations

import datetime
import os
import struct
import zlib

import numpy as np


def timestamp_name(ext: str = "bmp", now: datetime.datetime = None) -> str:
    """`save()` naming parity: %Y-%m-%d_%H-%M-%S (`Program.cpp:71-84`)."""
    now = now or datetime.datetime.now()
    return now.strftime("%Y-%m-%d_%H-%M-%S") + "." + ext


def _linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    """Host-side (numpy) sRGB OETF: encode runs on a host copy."""
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.power(np.maximum(c, 1e-12), 1.0 / 2.4) - 0.055)


def to_srgb_u8(img_linear: np.ndarray) -> np.ndarray:
    """(H, W, 3) linear float → (H, W, 3) uint8 sRGB."""
    srgb = _linear_to_srgb_np(np.asarray(img_linear, np.float32))
    return np.clip(np.round(srgb * 255.0), 0, 255).astype(np.uint8)


def save_bmp(path: str, img_linear: np.ndarray) -> None:
    """24-bit BGR bottom-up BMP — byte-compatible with SOIL's BMP output
    layout (`Graphics.cpp:788-796`)."""
    u8 = to_srgb_u8(img_linear)
    h, w, _ = u8.shape
    row_size = (w * 3 + 3) & ~3
    img_size = row_size * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 54 + img_size, 0, 0, 54,
        40, w, h, 1, 24, 0, img_size, 2835, 2835, 0, 0)
    rows = []
    pad = b"\x00" * (row_size - w * 3)
    bgr = u8[::-1, :, ::-1]  # bottom-up, BGR
    for r in range(h):
        rows.append(bgr[r].tobytes() + pad)
    with open(path, "wb") as f:
        f.write(header + b"".join(rows))


def png_bytes(img_linear: np.ndarray) -> bytes:
    """Encode linear float32 → PNG bytes in memory (8-bit RGB, one sRGB
    OETF)."""
    u8 = to_srgb_u8(img_linear)
    h, w, _ = u8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + u8[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path: str, img_linear: np.ndarray) -> None:
    """Minimal zlib PNG encoder (8-bit RGB, sRGB-encoded)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img_linear))


def save_npy(path: str, img_linear: np.ndarray) -> None:
    """Raw linear float32 — lossless archival format."""
    np.save(path, np.asarray(img_linear, np.float32))


def save_image(path: str, img_linear: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        save_bmp(path, img_linear)
    elif ext == ".png":
        save_png(path, img_linear)
    elif ext == ".npy":
        save_npy(path, img_linear)
    else:
        raise ValueError(f"unsupported image extension {ext}")
