"""Profiling helpers: `torch.profiler` traces and synchronised wall timers.

The reference measures wall time with `clock()` around the render loop
(`Program.cpp:129-134,191-192`) and once measured its shader compile time
(`Graphics.cpp:197-198`).  The port's counterparts, as the JAX package's
`utils/profiling.py`: a timer that waits for the device at its end and
separates the first call (an nvcc build and load where a kernel's library
is not built yet) from the steady state, and a profiler trace.  The CUDA
kernels launch through ctypes, so `kernels.build.CudaKernel.launch` opens
a `record_function` span named after the entry point: the trace names
every launch even where CUPTI records no device events.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def synchronize() -> None:
    """Wait for the CUDA work queued so far; nothing when CUDA was never
    initialised (the CPU runs synchronously)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_block(label: str = "", result: dict = None):
    """Wall-time a block, waiting for the device's queued work at its end.
    `result` (optional dict) receives {label: seconds}."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        synchronize()
        if result is not None:
            result[label or "block"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace_to(logdir: str):
    """A `torch.profiler` session over the block (CPU activities, and CUDA
    where a card is present); at its end the Chrome trace is written to
    `logdir/trace-<pid>-<ms>.json`.  Yields the profiler, for
    `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def compile_and_steady(fn, *args, reps: int = 3):
    """Split the first call's time (a kernel's build and load included)
    from the best of `reps` synchronised calls.  Returns (first_s,
    steady_s, last output)."""
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize()
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize()
        best = min(best, time.perf_counter() - t0)
    return first_s, best, out
