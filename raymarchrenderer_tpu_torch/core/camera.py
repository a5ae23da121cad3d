"""Pinhole camera: eye + look direction + aspect + vfov -> frustum corners.

The port's twin of the JAX package's `core/camera.py` (see its docstring
for the deviation from reference HEAD's camera, which this keeps).  The
corner math is host-side Python over float32 numpy scalars, in the JAX
package's op order, so the corners agree with it to the last ulp or two
(its `lax.rsqrt` differs from the 1/sqrt used here by 1 ulp).
`corner_rays` returns (eye, ray00, ray10, ray01, ray11) as five (3,)
float32 arrays, first digit horizontal (0 = left), second vertical (0 =
top image row); `corner_rays_flat` the same as one (5, 3) float32 tensor.

The interactive operations (`Camera.cpp:104-137`: `zoom`, `pan`,
`orbit`) move the pose as the JAX package's do: `zoom` and `pan` in
Python floats, `orbit` through `rotate_axis` about up, then about right,
normalising after each, in float32 (numpy's `cos` / `sin` are an ulp
from XLA:CPU's, so a pose after any sequence agrees to about 1e-7).
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


def _rotate_axis(u, t: float, p):
    """`core.vecmath.rotate_axis` on float32 host triples: p ct - (u x p)
    st + u (u.p)(1 - ct), the reference's handedness."""
    ct = np.cos(_F(t))
    st = np.sin(_F(t))
    k = _dot(u, p) * (_F(1.0) - ct)
    return tuple(pc * ct - xc * st + uc * k
                 for pc, xc, uc in zip(p, _cross(u, p), u))


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

    def zoom(self, amount: float) -> None:
        """Move the eye along the view direction."""
        self.eye = tuple(e + d * amount
                         for e, d in zip(self.eye, self.direction))

    def pan(self, dx: float, dy: float) -> None:
        """Move the eye along the screen's right and up axes."""
        r, u, _ = self._frame()
        self.eye = tuple(e + float(ax) * dx + float(ay) * dy
                         for e, ax, ay in zip(self.eye, r, u))

    def orbit(self, ax: float, ay: float) -> None:
        """Turn the view direction by `ax` about up, then `ay` about
        right."""
        r, u, _ = self._frame()
        d = tuple(_F(c) for c in self.direction)
        d = _normalized(_rotate_axis(u, ax, d))
        d = _normalized(_rotate_axis(r, ay, d))
        self.direction = tuple(float(c) for c in d)

    def look_at(self, target: tuple) -> None:
        d = tuple(t - e for t, e in zip(target, self.eye))
        n = math.sqrt(sum(c * c for c in d))
        self.direction = tuple(c / n for c in d)

    def corner_rays(self) -> tuple:
        """(eye, ray00 (top-left), ray10 (top-right), ray01 (bottom-left),
        ray11 (bottom-right)) as (3,) float32 arrays.  Corners stay
        unnormalized: bilinear interpolation then per-pixel normalization
        is the exact pinhole projection."""
        r, u, d = self._frame()
        tv = _F(math.tan(self.fov / 2.0))
        th = _F(self.aspect * math.tan(self.fov / 2.0))
        rows = [np.asarray(self.eye, np.float32)]
        for sh, sv in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
            # d -/+ r*th +/- u*tv; a sign flip is exact, so this is the
            # JAX package's `d - r * th + u * tv` rounding for rounding
            rows.append(np.asarray(
                [(dc - _F(sh) * (rc * th)) + _F(sv) * (uc * tv)
                 for dc, rc, uc in zip(d, r, u)], np.float32))
        return tuple(rows)

    def corner_rays_flat(self, device="cuda") -> torch.Tensor:
        """`corner_rays` as one (5, 3) float32 tensor on `device` (the
        card by default); the renders route by this tensor's device."""
        return torch.tensor(np.stack(self.corner_rays()), device=device)
