"""Build a hand-written CUDA source of `csrc/` with nvcc and bind it with
ctypes.

Each source is compiled for Hopper (`sm_90a`) into a shared library with a
plain C entry point, at first use, under `build/raymarchrenderer_tpu_torch/`
beside the package, named by a hash of the source, every `csrc/*.cuh`
header and the command, so an edited source or header rebuilds and an
unchanged one is loaded as it is.  Kernels that share a source (two entry
points of one file) share its library, and a lock per library path lets
one thread compile it while the others wait and load it.  Nothing is
compiled or imported from CUDA when this module is imported.

The library directory is the port's compilation cache (the counterpart of
the JAX package's persistent XLA cache): `set_library_dir` moves it (the
CLI's `--cache-dir`), `fresh_library_dir` points it at a new temporary
directory, so nvcc runs again (`--no-cache`); no environment variable
moves it.  `CudaKernel.launch` runs inside the span
`utils.profiling.span(entry)`, a `torch.profiler` `record_function` named
after the entry point while a profiler records (beside the port's `rmr.*`
layer spans), and a flag check otherwise, so a profiler trace names the
launches made through ctypes.  The entry points select their card with
`cudaSetDevice`; `launch` sets the process's current device back to the
one it found, so launches on several cards leave it where it was.

Numerics flags: `--fmad=false` keeps every multiply and add separately
rounded, as in the plain PyTorch versions, and fast math stays off (so
`sqrtf` and `/` are correctly rounded).  `-Xptxas -v` makes every build
report each kernel's registers and spills (`CudaKernel.build_log`,
`ptxas_usage`).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from raymarchrenderer_tpu_torch.utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / _PKG.name

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


_library_dir = None      # None: BUILD_DIR


def library_dir() -> Path:
    """Where the kernels' libraries are built and loaded from."""
    return BUILD_DIR if _library_dir is None else _library_dir


def set_library_dir(path) -> Path:
    """Build into and load from `path` (None: the default `BUILD_DIR`);
    returns the previous setting, for the caller to restore."""
    global _library_dir
    previous = _library_dir
    _library_dir = None if path is None else Path(path)
    return previous


@contextlib.contextmanager
def fresh_library_dir():
    """Build into a new temporary directory for the block and remove it
    at the end (a library already loaded in this process stays loaded)."""
    with tempfile.TemporaryDirectory(prefix="rmr-kernels-") as tmp:
        previous = set_library_dir(tmp)
        try:
            yield Path(tmp)
        finally:
            set_library_dir(previous)


_LOCKS_GUARD = threading.Lock()
_BUILD_LOCKS = {}        # library path -> the lock its builders share


def _build_lock(lib: Path) -> threading.Lock:
    with _LOCKS_GUARD:
        return _BUILD_LOCKS.setdefault(lib, threading.Lock())


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


def compile_source(src: Path, out: Path) -> str:
    """nvcc `src` into the shared library `out`; returns nvcc's output,
    which holds ptxas's resource usage of every kernel.  Raises when nvcc
    fails."""
    proc = subprocess.run(nvcc_command(find_nvcc(), Path(src), Path(out)),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {Path(src).name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def ptxas_usage(log: str) -> dict:
    """{kernel (mangled name): {"registers", "spill_stores", "spill_loads"}}
    from the `-Xptxas -v` lines of an nvcc output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return {k: v for k, v in usage.items() if "registers" in v}


@contextlib.contextmanager
def _same_device():
    """Keep the process's current CUDA device across the block: an entry
    point selects its launch's card with `cudaSetDevice` and leaves it
    selected, so without this a launch on cuda:3 would send every later
    tensor made on "cuda" to card 3."""
    if not torch.cuda.is_initialized():
        yield
        return
    before = torch.cuda.current_device()
    try:
        yield
    finally:
        torch.cuda.set_device(before)


class CudaKernel:
    """One `csrc/*.cu` file and its C entry point.

    `launches` counts the launches made through `launch`, and nothing
    else adds to it.  `build_seconds` and `build_log` are the wall time
    and the output of the nvcc run this kernel made (0.0 and "" when its
    library was already built, by an earlier run or by another kernel of
    the same source)."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds = 0.0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return library_dir() / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build(self):
        """Compile (if needed) and load; returns the ctypes function."""
        if self._fn is not None:
            return self._fn
        lib = self.library_path()
        with _build_lock(lib):
            if not lib.exists():
                lib.parent.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
                t0 = time.perf_counter()
                self.build_log = compile_source(self.source, tmp)
                os.replace(tmp, lib)
                self.build_seconds = time.perf_counter() - t0
        fn = getattr(ctypes.CDLL(str(lib)), self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        fn = self.build()
        with span(self.entry), _same_device():
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {err}")
        self.launches += 1


def main(argv=None) -> int:
    """python -m raymarchrenderer_tpu_torch.kernels.build SOURCE.cu ...:
    compile each source as the kernels are built (into a temporary
    directory) and print ptxas's registers and spills of its kernels."""
    import argparse
    import tempfile
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("sources", nargs="+", type=Path)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        for src in args.sources:
            log = compile_source(src, Path(tmp) / f"{src.stem}.so")
            for name, use in ptxas_usage(log).items():
                print(f"{src}: {name}: {use['registers']} registers, "
                      f"{use.get('spill_stores', 0)} / "
                      f"{use.get('spill_loads', 0)} bytes spill stores / "
                      "loads")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
