"""Direction sampling for the spectral transport.

`randHemisphere` (`RayMarch3.glsl:202-236`): a uniform sphere point via
theta = 2*pi*u1, phi = acos(2*u2 - 1), flipped so z >= 0 and rotated into
the normal's frame built by `makeViewMat` (locZ = normal).  A zero normal
returns the raw uniform-sphere direction.  Same op order as the JAX
package's `core/sampling.py`; `torch.sin`/`torch.cos` differ from
XLA:CPU's by 1 ulp in a few percent of inputs.
"""
from __future__ import annotations

import torch

from .vecmath import Vec3, make_onb, vselect

_PI = 3.14159265358979323846


def uniform_sphere(u1, u2) -> Vec3:
    theta = 2.0 * _PI * u1
    cos_phi = 2.0 * u2 - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    return Vec3(sin_phi * torch.cos(theta), cos_phi,
                sin_phi * torch.sin(theta))


def uniform_sphere_or_hemisphere(u1, u2, normal: Vec3) -> Vec3:
    """randHemisphere including the zero-normal pass-through branch."""
    b = uniform_sphere(u1, u2)
    zero_n = (normal.x == 0.0) & (normal.y == 0.0) & (normal.z == 0.0)
    bh = vselect(b.z < 0.0, -b, b)
    x, y, z = make_onb(normal)
    rotated = x * bh.x + y * bh.y + z * bh.z
    return vselect(zero_n, b, rotated)
