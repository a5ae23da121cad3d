"""ctypes bindings of the native render scheduler (`native/scheduler.cpp`),
the host twin of the reference's spiral walk and progressive work queue
(`Program.cpp:107-299`), on the library `io.native_bindings` builds.

`available()` says whether the library loaded; `render.tiles` takes the
pure-Python walk otherwise, which emits the same order.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, Tuple

import numpy as np

from raymarchrenderer_tpu_torch.io.native_bindings import SCHEDULER


def available() -> bool:
    return SCHEDULER.load() is not None


def spiral_order(grid_w: int, grid_h: int) -> List[Tuple[int, int]]:
    """The whole spiral visit order of a grid_w x grid_h tile grid."""
    lib = SCHEDULER.load()
    out = np.empty(2 * grid_w * grid_h, np.int32)
    n = lib.rmr_spiral_order(
        grid_w, grid_h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    SCHEDULER.count("rmr_spiral_order")
    return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]


class NativeScheduler:
    """Progressive work queue: yields (tile_x, tile_y, sample) units.

    spp > 0: finite mode, every sample of a tile before the spiral
    advances.  spp == 0: endless mode, one sample per tile per pass,
    forever (the reference's samples == 0 loop); `cancel()` ends it with
    the accumulation still valid."""

    def __init__(self, grid_w: int, grid_h: int, spp: int):
        self._lib = SCHEDULER.load()
        if self._lib is None:
            raise RuntimeError(f"native scheduler unavailable: "
                               f"{SCHEDULER.error}")
        self._h = self._lib.rmr_sched_create(grid_w, grid_h, spp)
        SCHEDULER.count("rmr_sched_create")
        if not self._h:
            raise ValueError(f"bad scheduler args ({grid_w}, {grid_h}, {spp})")

    def __iter__(self) -> Iterator[Tuple[int, int, int]]:
        out = (ctypes.c_int32 * 3)()
        while self._lib.rmr_sched_next(self._h, out):
            yield (out[0], out[1], out[2])

    def cancel(self) -> None:
        self._lib.rmr_sched_cancel(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rmr_sched_destroy(self._h)
            self._h = None
