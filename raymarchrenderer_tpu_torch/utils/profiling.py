"""Profiling helpers: `torch.profiler` spans and traces.

The reference measures wall time with `clock()` around the render loop
(`Program.cpp:129-134,191-192`).  The port names its layers in a
`torch.profiler` trace instead: `span(name)` is a `record_function`
while a profiler records, and a shared no-op context manager otherwise,
so an untraced run pays one flag check a span.  The spans land in the
profiler's Chrome trace beside the CUPTI device events, on one clock:

  * `rmr.pass` — a pass of `render.tiles.ProgressiveRenderer`;
  * `rmr.scene_buffers` — a launch's scene program and data
    (`kernels.scene_program`): the data gathered on the device, and, at
    the first build on a scene and device, `rmr.scene_compile` inside it,
    the host's compile of the object and material programs and their
    upload;
  * `rmr.record` — a recorder launch of a train step;
  * `rmr.forward`, `rmr.backward`, `rmr.update` — the differentiable
    forward and loss, the gradients, and the parameter update of a train
    step (`parallel.sharding`);
  * `rmr_<entry>` — each ctypes launch of a CUDA kernel
    (`kernels.build.CudaKernel.launch`), so the trace names every launch
    even where CUPTI records no device events.

`trace_to` writes such a trace (`render --profile`).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `torch.profiler.record_function(name)` while a profiler records;
    otherwise the one shared no-op context manager, which records
    nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def synchronize() -> None:
    """Wait for the CUDA work queued so far; nothing when CUDA was never
    initialised (the CPU runs synchronously)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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

