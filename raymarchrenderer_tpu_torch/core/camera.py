"""Pinhole camera: eye + look direction + aspect + vfov -> frustum corners.

The port's twin of the JAX package's `core/camera.py` (see its docstring
for the deviation from reference HEAD's camera, which this keeps).  The
corner math is host-side Python over float32 numpy scalars, in the JAX
package's op order, so the corners agree with it to the last ulp or two
(its `lax.rsqrt` differs from the 1/sqrt used here by 1 ulp).
`corner_rays_flat` returns one (5, 3) float32 tensor:
(eye, ray00, ray10, ray01, ray11), first digit horizontal (0 = left),
second vertical (0 = top image row).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_F = np.float32


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalized(a):
    inv = _F(1.0) / np.sqrt(np.maximum(_dot(a, a), _F(1e-24)))
    return tuple(c * inv for c in a)


@dataclasses.dataclass
class Camera:
    """Host-side camera state (`Camera.cpp:104-137` parity)."""

    eye: tuple = (0.0, 4.0, -6.0)
    direction: tuple = None  # defaults to normalize(0,-3,6) like Program.cpp:102
    aspect: float = 1.0
    fov: float = math.pi / 4  # vertical FOV (Program.cpp:102)

    def __post_init__(self):
        if self.direction is None:
            self.direction = (0.0, -3.0, 6.0)
        n = math.sqrt(sum(c * c for c in self.direction))
        self.direction = tuple(c / n for c in self.direction)

    def _frame(self):
        """(right, up, forward): right = world_up x dir (x when looking
        straight up or down), up = dir x right."""
        d = tuple(_F(c) for c in self.direction)
        up_w = (_F(0.0), _F(1.0), _F(0.0))
        r = _cross(up_w, d)
        if float(_dot(r, r)) < 1e-12:
            r = (_F(1.0), _F(0.0), _F(0.0))
        r = _normalized(r)
        u = _normalized(_cross(d, r))
        return r, u, d

    def look_at(self, target: tuple) -> None:
        d = tuple(t - e for t, e in zip(target, self.eye))
        n = math.sqrt(sum(c * c for c in d))
        self.direction = tuple(c / n for c in d)

    def corner_rays_flat(self, device="cuda") -> torch.Tensor:
        """(5, 3) float32 tensor on `device` (the card by default): eye,
        ray00 (top-left), ray10 (top-right), ray01 (bottom-left), ray11
        (bottom-right); the renders route by this tensor's device.
        Corners stay unnormalized: bilinear interpolation then per-pixel
        normalization is the exact pinhole projection."""
        r, u, d = self._frame()
        tv = _F(math.tan(self.fov / 2.0))
        th = _F(self.aspect * math.tan(self.fov / 2.0))
        rows = [tuple(_F(c) for c in self.eye)]
        for sh, sv in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
            # d -/+ r*th +/- u*tv; a sign flip is exact, so this is the
            # JAX package's `d - r * th + u * tv` rounding for rounding
            rows.append(tuple((dc - _F(sh) * (rc * th)) + _F(sv) * (uc * tv)
                              for dc, rc, uc in zip(d, r, u)))
        return torch.tensor(np.asarray(rows, np.float32), device=device)
