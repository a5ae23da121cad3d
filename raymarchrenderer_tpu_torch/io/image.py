"""Image I/O: linear float accumulation -> sRGB BMP/PNG, or float EXR/NPY;
and the readers of a train target (BMP, PNG, EXR).

The reference saves its accumulation buffer as an sRGB-encoded BMP
(`Graphics::SaveImage`, `Graphics.cpp:754-799`) named
"%Y-%m-%d_%H-%M-%S.bmp" (`Program.cpp:71-84`).  The buffer stays float32
linear and ONE explicit sRGB OETF applies at encode time.  These are the
JAX package's pure-Python encoders (24-bit bottom-up BGR BMP, zlib PNG)
and its OpenEXR writer (`save_exr`), byte for byte, and its numpy-only
readers (`load_bmp`, `load_png`, `load_png_bytes`, `load_exr`,
`_srgb_to_linear_np`).  As there, the native C++ encoder of `native/`
(`io.native_bindings`: the sRGB conversion, the BMP and PNG writers) is
used where its library loads, and the Python encoders, which write the
same bytes from the same 8-bit values, are the plain versions.  Images
are numpy arrays: callers hand over `tensor.cpu().numpy()`.
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
    """(H, W, 3) linear float → (H, W, 3) uint8 sRGB (the native encoder
    where it loads: within one level of the numpy OETF)."""
    src = np.asarray(img_linear, np.float32)
    native = _native_encoder()
    if native is not None:
        return native.linear_to_srgb_u8(src)
    srgb = _linear_to_srgb_np(src)
    return np.clip(np.round(srgb * 255.0), 0, 255).astype(np.uint8)


def _native_encoder():
    from raymarchrenderer_tpu_torch.io import native_bindings
    return native_bindings if native_bindings.available() else None


def save_bmp(path: str, img_linear: np.ndarray) -> None:
    """24-bit BGR bottom-up BMP — byte-compatible with SOIL's BMP output
    layout (`Graphics.cpp:788-796`)."""
    u8 = to_srgb_u8(img_linear)
    native = _native_encoder()
    if native is not None:
        native.write_bmp(path, u8)
        return
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
    native = _native_encoder()
    if native is not None:
        native.write_png(path, to_srgb_u8(img_linear))
        return
    with open(path, "wb") as f:
        f.write(png_bytes(img_linear))


def save_npy(path: str, img_linear: np.ndarray) -> None:
    """Raw linear float32 — lossless archival format."""
    np.save(path, np.asarray(img_linear, np.float32))


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def save_exr(path: str, img_linear: np.ndarray) -> None:
    """OpenEXR 2.0 writer: single-part scanline, float32 B/G/R channels,
    no compression, increasing-Y; linear radiance."""
    img = np.ascontiguousarray(np.asarray(img_linear, np.float32))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_exr expects (H, W, 3), got {img.shape}")
    h, w, _ = img.shape

    # channel list, alphabetical (B, G, R), pixelType 2 = FLOAT
    def chan(name: bytes) -> bytes:
        return name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    chlist = chan(b"B") + chan(b"G") + chan(b"R") + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<I", 20000630)       # magic
        + struct.pack("<I", 2)            # version 2, no flags
        + _exr_attr(b"channels", b"chlist", chlist)
        + _exr_attr(b"compression", b"compression", b"\x00")  # NONE
        + _exr_attr(b"dataWindow", b"box2i", box)
        + _exr_attr(b"displayWindow", b"box2i", box)
        + _exr_attr(b"lineOrder", b"lineOrder", b"\x00")      # increasing Y
        + _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
        + _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\x00")                        # end of header

    row_bytes = 3 * 4 * w                 # 3 float32 channels per scanline
    chunk_bytes = 8 + row_bytes           # y:int32 + size:int32 + data
    data_pos = len(header) + 8 * h        # offset table: one uint64 per line
    offsets = np.arange(h, dtype=np.uint64) * chunk_bytes + data_pos
    # per-scanline chunk payload: B row, G row, R row (channel-planar)
    planar = np.ascontiguousarray(np.transpose(img[:, :, ::-1], (0, 2, 1)))
    with open(path, "wb") as f:
        f.write(header)
        f.write(offsets.tobytes())
        for y in range(h):
            f.write(struct.pack("<ii", y, row_bytes))
            f.write(planar[y].tobytes())


def save_image(path: str, img_linear: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        save_bmp(path, img_linear)
    elif ext == ".png":
        save_png(path, img_linear)
    elif ext == ".exr":
        save_exr(path, img_linear)
    elif ext == ".npy":
        save_npy(path, img_linear)
    else:
        raise ValueError(f"unsupported image extension {ext}")


def load_exr(path: str) -> np.ndarray:
    """Decode the EXRs we write (uncompressed float32 scanline, RGB) →
    (H, W, 3) linear float32."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<II", data, 0)
    assert magic == 20000630, "not an EXR file"
    assert version & 0xFF == 2 and not (version >> 8), "unsupported EXR flags"
    pos = 8
    channels, box = [], None
    compression = 0
    while data[pos] != 0:                 # attribute loop
        end = data.index(b"\x00", pos)
        name = data[pos:end]
        pos = end + 1
        end = data.index(b"\x00", pos)
        typ = data[pos:end]
        pos = end + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        body = data[pos:pos + size]
        pos += size
        if name == b"dataWindow":
            box = struct.unpack("<iiii", body)
        elif name == b"compression":
            compression = body[0]
        elif name == b"channels":
            p = 0
            while body[p] != 0:
                e = body.index(b"\x00", p)
                cname = body[p:e].decode()
                (ptype,) = struct.unpack_from("<i", body, e + 1)
                channels.append((cname, ptype))
                p = e + 1 + 16
    pos += 1                              # header terminator
    assert compression == 0, "only uncompressed EXR supported"
    assert all(t == 2 for _, t in channels), "only float32 channels supported"
    w = box[2] - box[0] + 1
    h = box[3] - box[1] + 1
    offsets = np.frombuffer(data, np.uint64, h, pos)
    names = [n for n, _ in channels]
    out = np.zeros((h, len(names), w), np.float32)
    for i, off in enumerate(offsets):
        o = int(off)
        y, size = struct.unpack_from("<ii", data, o)
        row = np.frombuffer(data, np.float32, len(names) * w, o + 8)
        out[y - box[1]] = row.reshape(len(names), w)
    idx = [names.index(c) for c in ("R", "G", "B") if c in names]
    if len(idx) == 3:
        return np.ascontiguousarray(out[:, idx].transpose(0, 2, 1))
    return np.ascontiguousarray(out.transpose(0, 2, 1))


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92,
                    np.power((c + 0.055) / 1.055, 2.4))


def load_bmp(path: str) -> np.ndarray:
    """Decode an uncompressed (BI_RGB) BMP → (H, W, 3) uint8 RGB,
    top-down row order.  24-bit is the format the reference's
    `SaveImage` emits via SOIL (`Graphics.cpp:754-799`) and round-trips
    our own `save_bmp`; 8-bit palettized is also read (one 2015 golden —
    `output/2015-07-20_20-46.bmp` — was saved through an indexed
    pipeline)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM", "not a BMP file"
    (offset,) = struct.unpack_from("<I", data, 10)
    hdr_size, w, h = struct.unpack_from("<Iii", data, 14)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    (compression,) = struct.unpack_from("<I", data, 30)
    assert hdr_size >= 40 and bpp in (8, 24) and compression == 0, (
        f"unsupported BMP variant (bpp={bpp}, compression={compression})")
    flip = h > 0          # positive height = bottom-up storage
    h = abs(h)
    if bpp == 8:
        (colors_used,) = struct.unpack_from("<I", data, 46)
        n_pal = colors_used or 256
        pal = np.frombuffer(data, np.uint8, n_pal * 4,
                            14 + hdr_size).reshape(n_pal, 4)
        row_size = (w + 3) & ~3
        idx = np.frombuffer(data, np.uint8, row_size * h, offset)
        idx = idx.reshape(h, row_size)[:, :w]
        rows = pal[idx, :3]                       # BGRX palette entries
        if flip:
            rows = rows[::-1]
        return np.ascontiguousarray(rows[:, :, ::-1])  # BGR → RGB
    row_size = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, row_size * h, offset)
    rows = rows.reshape(h, row_size)[:, :w * 3].reshape(h, w, 3)
    if flip:
        rows = rows[::-1]
    return np.ascontiguousarray(rows[:, :, ::-1])  # BGR → RGB


def load_png(path: str) -> np.ndarray:
    """Decode the PNGs we write (8-bit RGB, filter 0) → linear float32."""
    with open(path, "rb") as f:
        data = f.read()
    return load_png_bytes(data)


def load_png_bytes(data: bytes) -> np.ndarray:
    """`load_png` over an in-memory buffer (e.g. the viewer's
    ``/api/image.png`` response)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = [np.frombuffer(raw[r * stride + 1:(r + 1) * stride], np.uint8)
            for r in range(h)]
    u8 = np.stack(rows).reshape(h, w, 3)
    return _srgb_to_linear_np(u8.astype(np.float32) / 255.0)
