"""What the split cell's per-layer metrics read from a traced window:
its frames, each frame's megakernel launches on each card, and each
card's busy time.

A frame ends in the program's `rmr.merge` span (`parallel.sharding`:
the merge on cuda:0, from its first copy between cards to the divide).
A device event belongs to frame i when the runtime call that launched it,
matched by `args.correlation`, starts after the end of merge span i - 1
and before the end of merge span i; the events launched inside span i
are the frame's merge.  A parent commit without the span has no frames,
and every reader built on this module then returns None.
"""
from __future__ import annotations

from rmbench import spans
from rmbench.trace import union

KERNEL = "mega_spectral_kernel"


def device_of(e) -> int:
    """The card of a device event (the trace's `args.device`, else its
    process id, which the profiler sets to the card's index)."""
    return int(e.get("args", {}).get("device", e.get("pid", -1)))


def _launch_times(tr) -> dict:
    out = {}
    for e in tr.host:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in spans.RUNTIME_CATS and corr is not None:
            out[corr] = float(e["ts"])
    return out


def frames(tr) -> list:
    """[{"kernels": {card: [events]}, "merge": [events]}] of every frame
    with a megakernel launch and a merge, in order."""
    merges = sorted(spans.spans(tr, "rmr.merge"))
    if not merges:
        return []
    launched = _launch_times(tr)
    out = [{"kernels": {}, "merge": []} for _ in merges]
    ends = [e for _, e in merges]
    for e in tr.device:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = next((j for j, end in enumerate(ends) if t <= end), None)
        if i is None:
            continue
        if t >= merges[i][0]:
            out[i]["merge"].append(e)
        elif e.get("cat") == "kernel" and KERNEL in e["name"]:
            out[i]["kernels"].setdefault(device_of(e), []).append(e)
    return [f for f in out if f["kernels"] and f["merge"]]


def start(e) -> float:
    return float(e["ts"])


def end(e) -> float:
    return float(e["ts"]) + float(e["dur"])


def card_busy_share(tr, card: int) -> float:
    """The share of the window in which a kernel, copy or fill ran on
    `card`."""
    inside = [(max(start(e), tr.t0), min(end(e), tr.t1))
              for e in tr.device if device_of(e) == card]
    busy = sum(b - a for a, b in union([(a, b) for a, b in inside
                                        if b > a]))
    return busy / (tr.t1 - tr.t0)
