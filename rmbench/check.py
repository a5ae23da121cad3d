"""The comparison that decides `correct`, and its control.

A pixel value of the program is off when it differs from the reference's
by more than `ABS_TOL + REL_TOL * |reference|`.  The program's kernels and
the reference's plain schedules round every operation alike, so nearly
every value agrees to the bit; a value is off where one path of its
pixel took another branch.  The numbers compared are shares of off
values, each held to a limit of the cell's own
(`limits/<workload>.json`), set from sound runs' readings and from the
control's (`PERF.md`).

The control is the reference put in the program's place and computed
in the nearest precision below the configuration's float32: bfloat16,
every floating-point result of its operations rounded to bfloat16
(`bf16_control`).
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

ABS_TOL = 1e-5
REL_TOL = 1e-5

_ROOT = Path(__file__).resolve().parent


def off_mask(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per value: off by more than the tolerance, or not finite."""
    diff = (got - want).abs()
    return ~(diff <= ABS_TOL + REL_TOL * want.abs())


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if isinstance(x, (tuple, list)):
        return type(x)(_round(v) for v in x)
    return x


class _Bf16(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _round(func(*args, **(kwargs or {})))


@contextlib.contextmanager
def bf16_control():
    """Inside the block every float32 result of a torch operation is
    rounded to bfloat16: the reference run in the precision below its
    configuration's."""
    with _Bf16():
        yield


def load_limits(workload: str, root: Path = _ROOT) -> dict:
    """{number: limit} of a cell, from `limits/<workload>.json`."""
    doc = json.loads((root / "limits" / f"{workload}.json").read_text())
    return {k: float(v["limit"]) for k, v in doc["numbers"].items()}


def judge(readings: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing or NaN reading
    fails)."""
    for name, limit in limits.items():
        value = readings.get(name)
        if value is None or not value <= limit:
            return False
    return True
