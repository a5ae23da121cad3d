"""Build a hand-written CUDA source of `csrc/` with nvcc and bind it with
ctypes.

Each source is compiled for Hopper (`sm_90a`) into a shared library with a
plain C entry point, at first use, under `build/raymarchrenderer_tpu_torch/`
beside the package, named by a hash of the source and the command, so an
edited source rebuilds and an unchanged one is loaded as it is.  Nothing is
compiled or imported from CUDA when this module is imported.

Numerics flags: `--fmad=false` keeps every multiply and add separately
rounded, as in the plain PyTorch versions, and fast math stays off (so
`sqrtf` and `/` are correctly rounded).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / _PKG.name

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """nvcc from PATH, else under CUDA_HOME / CUDA_PATH."""
    found = shutil.which("nvcc")
    if found:
        return found
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def nvcc_command(nvcc: str, src: Path, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


class CudaKernel:
    """One `csrc/*.cu` file and its C entry point.

    `launches` counts the launches made through `launch`, and nothing
    else adds to it.  `build_seconds` is the wall time of the last build
    (0.0 when the library was already built)."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds = 0.0
        self._fn = None

    def library_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{key[:16]}.so"

    def build(self):
        """Compile (if needed) and load; returns the ctypes function."""
        if self._fn is not None:
            return self._fn
        lib = self.library_path()
        if not lib.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            t0 = time.perf_counter()
            proc = subprocess.run(nvcc_command(nvcc, self.source, tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
            self.build_seconds = time.perf_counter() - t0
        fn = getattr(ctypes.CDLL(str(lib)), self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        err = self.build()(*args)
        if err != 0:
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {err}")
        self.launches += 1
