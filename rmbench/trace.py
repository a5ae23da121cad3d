"""The traced run: a `torch.profiler` session over the measured window,
its Chrome trace, and the readings the per-layer metrics take from it.

Device activity is every CUPTI event of the categories in `DEVICE_CATS`
(kernels, copies, fills); busy time is the union of their intervals
inside the window (the `rmbench.window` span); an idle gap is a stretch
of the window with no device activity, named by the shortest host event
(an op, a runtime call or a span of the harness's) that covers its
midpoint.
"""
from __future__ import annotations

import contextlib
import heapq
import json
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW_SPAN = "rmbench.window"


@contextlib.contextmanager
def profiled(path):
    """Profile the block (CPU and CUDA activities) inside a
    `rmbench.window` span and write the Chrome trace to `path`."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
        torch.cuda.synchronize()
    finally:
        prof.stop()
    prof.export_chrome_trace(str(path))


def union(intervals):
    """Merged, sorted, disjoint (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The parsed Chrome trace of one window (times in microseconds, as
    the trace writes them)."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in events if e.get("name") == WINDOW_SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
        w = spans[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        inside = [(max(float(e["ts"]), self.t0),
                   min(float(e["ts"]) + float(e["dur"]), self.t1))
                  for e in self.device]
        self.busy = union([(s, e) for s, e in inside if e > s])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernels(self, name_part: str):
        """The device kernel events whose name holds `name_part`."""
        return [e for e in self.device
                if e.get("cat") == "kernel" and name_part in e["name"]]

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took the most
        time inside the window, summed by the profiler's name."""
        total = defaultdict(float)
        for e in self.device:
            s = max(float(e["ts"]), self.t0)
            end = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if end > s:
                total[e["name"]] += (end - s) * 1e-6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def gaps(self):
        """(start, end) of every stretch of the window without device
        activity."""
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_gaps(self, top: int = 10):
        """[[host activity, seconds]]: the window's idle time summed by
        the shortest host event that covers each gap's midpoint (the
        harness's `rmbench.window` span where nothing shorter does)."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] + g[1])
        host = sorted(self.host, key=lambda e: float(e["ts"]))
        total = defaultdict(float)
        heap, i = [], 0
        for s, e in gaps:
            mid = 0.5 * (s + e)
            while i < len(host) and float(host[i]["ts"]) <= mid:
                h = host[i]
                heapq.heappush(heap, (float(h["dur"]),
                                      float(h["ts"]) + float(h["dur"]), i))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = host[heap[0][2]]["name"] if heap else WINDOW_SPAN
            total[name] += (e - s) * 1e-6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]
