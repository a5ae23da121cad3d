"""The program's own profiler spans in a traced window, and what the
per-layer metrics read from them.

The port opens a `torch.profiler` `record_function` span (`rmr.*`, the
port's `utils.profiling.span`) at each layer boundary of the preview's
launch path and of the train step; the spans land in the window's Chrome
trace as `user_annotation` host events, on the clock of the CUPTI device
and runtime events.  A parent commit without them has no such events, and
every reader built on this module then returns None.

Two rules, shared by the readers:

  * a runtime call waits when it waits for the card or copies to it (any
    `*Synchronize`, any `cudaMemcpy*`), the rule of
    `driver_host_ms.preview`; a span's host time is its time less the
    time inside such calls;
  * a device event (kernel, copy, fill) belongs to a span when the
    runtime call that launched it, matched by `args.correlation`, starts
    inside the span by time, on any thread: autograd runs the backward's
    CUDA ops on a thread of its own while the calling thread sits inside
    `rmr.backward`.
"""
from __future__ import annotations

from bisect import bisect_right

from rmbench.trace import union

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def spans(tr, name: str) -> list:
    """(start, end) of every span `name` in the trace, in microseconds."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in tr.host
            if e.get("cat") == "user_annotation" and e["name"] == name]


def _waits(name: str) -> bool:
    return name.endswith("Synchronize") or name.startswith("cudaMemcpy")


def waits(tr) -> list:
    """Merged intervals of the runtime calls that wait for the card or
    copy to it."""
    return union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in tr.host
                  if e.get("cat") in RUNTIME_CATS and _waits(e["name"])])


class Cover:
    """The union of some intervals, for lookups by time."""

    def __init__(self, intervals):
        self.ivs = union(intervals)
        self.starts = [s for s, _ in self.ivs]

    def __contains__(self, t: float) -> bool:
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ivs[i][1]

    def length(self) -> float:
        return sum(e - s for s, e in self.ivs)

    def overlap(self, other: "Cover") -> float:
        """The length of this union's intersection with `other`'s."""
        total = 0.0
        for s, e in self.ivs:
            i = max(bisect_right(other.starts, s) - 1, 0)
            while i < len(other.ivs) and other.ivs[i][0] < e:
                a, b = other.ivs[i]
                total += max(0.0, min(b, e) - max(a, s))
                i += 1
        return total


def host_and_waits(tr, name: str):
    """(host us, waiting us) inside the union of the spans `name`: the
    spans' time less, and in, the runtime calls that wait for the card
    or copy to it."""
    cover = Cover(spans(tr, name))
    waiting = cover.overlap(Cover(waits(tr)))
    return cover.length() - waiting, waiting


def calls_inside(tr, name: str, prefix: str) -> int:
    """The runtime calls whose name starts with `prefix` and whose start
    lies inside a span `name`."""
    cover = Cover(spans(tr, name))
    return sum(1 for e in tr.host if e.get("cat") in RUNTIME_CATS
               and e["name"].startswith(prefix) and float(e["ts"]) in cover)


def device_events_of(tr, name: str, outside: str = None) -> list:
    """The device events launched inside a span `name` and, given
    `outside`, not inside a span `outside`."""
    inside = Cover(spans(tr, name))
    excluded = Cover(spans(tr, outside) if outside else [])
    launched = {}
    for e in tr.host:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in RUNTIME_CATS and corr is not None:
            launched[corr] = float(e["ts"])
    out = []
    for e in tr.device:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None and t in inside and t not in excluded:
            out.append(e)
    return out
