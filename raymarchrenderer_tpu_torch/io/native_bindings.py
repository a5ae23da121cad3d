"""The native host libraries of `native/`, built with g++ and bound with
ctypes: the image encoder (`encoder.cpp`: sRGB, BMP, PNG through zlib),
the Radiance .hdr decoder (`hdr.cpp`) and the render scheduler
(`scheduler.cpp`: the reference's spiral tile walk and progressive work
queue, `render.scheduler_native`).

These are host code, not device kernels.  Each library is built at its
first use from the repository's `native/*.cpp`, with
`g++ -O3 -fPIC -std=c++17 -shared` (and `-lz` for the encoder), into
`build/raymarchrenderer_tpu_torch/native/<hash>/lib<name>.so` beside the
package, the hash taken over the source and the command, so an edited
source rebuilds and an unchanged one loads as it is; a lock per library
lets one thread build it while the others wait.  (`native/Makefile`
builds into the JAX package, so it is never run from here.)

The pure-Python encoders and decoder (`io.image`, `io.hdr`,
`render.tiles.spiral_tiles_py`) stay the plain versions; `available()`
and its siblings say whether a library loaded.  A library that does not
build is not hidden: the compiler's error is printed to stderr once, the
callers take the Python path, and the library's `error` holds it.
Each library's `calls` counts the calls made into its functions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG.parent / "native"
BUILD_DIR = _PKG.parent / "build" / _PKG.name / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


class NativeLibrary:
    """One `native/*.cpp` source built into a shared library at first use.

    `load()` returns the `ctypes.CDLL` with its functions' types set, or
    None when the source is missing or does not build (`error` says why,
    printed once).  `build_seconds` is the wall time of the g++ run this
    process made (0.0 when the library was built already); `calls` maps
    each C function to the calls made through this module."""

    def __init__(self, name: str, source: str, link=(), bind=None):
        self.name = name
        self.source = NATIVE_SRC / source
        self.link = tuple(link)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.error = None
        self.build_seconds = 0.0
        self.calls = {}

    def count(self, fn: str) -> None:
        self.calls[fn] = self.calls.get(fn, 0) + 1

    def command(self, out: Path) -> list:
        return [shutil.which("g++") or "g++", *CXX_FLAGS, "-o", str(out),
                str(self.source), *self.link]

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join((*CXX_FLAGS, *self.link)).encode())
        return BUILD_DIR / h.hexdigest()[:16] / f"lib{self.name}.so"

    def _build(self) -> Path:
        if not self.source.exists():
            raise RuntimeError(f"native source {self.source} not found")
        lib = self.library_path()
        if not lib.exists():
            lib.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}."
                                f"{threading.get_ident()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run(self.command(tmp), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed on {self.source.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
            self.build_seconds = time.perf_counter() - t0
        return lib

    def load(self):
        if self._lib is not None or self.error is not None:
            return self._lib
        with self._lock:
            if self._lib is None and self.error is None:
                try:
                    lib = ctypes.CDLL(str(self._build()))
                    self._bind(lib)
                    self._lib = lib
                except (OSError, RuntimeError) as e:
                    self.error = str(e)
                    print(f"raymarchrenderer_tpu_torch: native library "
                          f"lib{self.name} unavailable, the Python path "
                          f"runs instead: {self.error}", file=sys.stderr,
                          flush=True)
        return self._lib


_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _bind_encoder(lib) -> None:
    lib.rmr_linear_to_srgb_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), _u8p, ctypes.c_int64]
    lib.rmr_linear_to_srgb_u8.restype = None
    lib.rmr_write_bmp.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int32,
                                  ctypes.c_int32]
    lib.rmr_write_bmp.restype = ctypes.c_int32
    lib.rmr_write_png.argtypes = lib.rmr_write_bmp.argtypes
    lib.rmr_write_png.restype = ctypes.c_int32


def _bind_hdr(lib) -> None:
    lib.rmr_hdr_probe.argtypes = [
        _u8p, ctypes.c_int64, _i32p, _i32p, ctypes.POINTER(ctypes.c_int64)]
    lib.rmr_hdr_probe.restype = ctypes.c_int32
    lib.rmr_hdr_decode.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.rmr_hdr_decode.restype = ctypes.c_int32


def _bind_scheduler(lib) -> None:
    lib.rmr_spiral_order.argtypes = [ctypes.c_int32, ctypes.c_int32, _i32p]
    lib.rmr_spiral_order.restype = ctypes.c_int32
    lib.rmr_sched_create.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32]
    lib.rmr_sched_create.restype = ctypes.c_void_p
    lib.rmr_sched_next.argtypes = [ctypes.c_void_p, _i32p]
    lib.rmr_sched_next.restype = ctypes.c_int32
    lib.rmr_sched_cancel.argtypes = [ctypes.c_void_p]
    lib.rmr_sched_cancel.restype = None
    lib.rmr_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.rmr_sched_destroy.restype = None


ENCODER = NativeLibrary("encoder", "encoder.cpp", ("-lz",), _bind_encoder)
HDR = NativeLibrary("hdr", "hdr.cpp", (), _bind_hdr)
SCHEDULER = NativeLibrary("scheduler", "scheduler.cpp", (), _bind_scheduler)
LIBRARIES = (ENCODER, HDR, SCHEDULER)


def available() -> bool:
    """Whether the encoder library loaded (built at the first call)."""
    return ENCODER.load() is not None


def available_hdr() -> bool:
    return HDR.load() is not None


def linear_to_srgb_u8(linear: np.ndarray) -> np.ndarray:
    """(..., 3) linear float -> uint8 sRGB through `rmr_linear_to_srgb_u8`
    (within one level of the numpy OETF)."""
    lib = ENCODER.load()
    src = np.ascontiguousarray(linear, np.float32)
    out = np.empty(src.shape, np.uint8)
    lib.rmr_linear_to_srgb_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(_u8p), ctypes.c_int64(src.size))
    ENCODER.count("rmr_linear_to_srgb_u8")
    return out


def _write(fn_name: str, path: str, rgb_u8: np.ndarray) -> None:
    lib = ENCODER.load()
    h, w, _ = rgb_u8.shape
    buf = np.ascontiguousarray(rgb_u8, np.uint8)
    rc = getattr(lib, fn_name)(os.fsencode(path), buf.ctypes.data_as(_u8p),
                               w, h)
    ENCODER.count(fn_name)
    if rc != 0:
        raise IOError(f"native encoder failed ({rc}) writing {path}")


def write_bmp(path: str, rgb_u8: np.ndarray) -> None:
    _write("rmr_write_bmp", path, rgb_u8)


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    _write("rmr_write_png", path, rgb_u8)


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode an in-memory Radiance .hdr file -> (H, W, 3) linear
    float32."""
    lib = HDR.load()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(_u8p)
    w, h, pos = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = lib.rmr_hdr_probe(src, len(data), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(pos))
    HDR.count("rmr_hdr_probe")
    if rc != 0:
        raise ValueError(f"native HDR probe failed ({rc})")
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.rmr_hdr_decode(src, len(data), w.value, h.value, pos.value,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    HDR.count("rmr_hdr_decode")
    if rc != 0:
        raise ValueError(f"native HDR decode failed ({rc})")
    return out
