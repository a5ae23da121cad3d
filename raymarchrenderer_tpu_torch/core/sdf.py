"""Signed distance primitives, CSG and domain operators over Vec3 tensors.

Op for op the JAX package's `core/sdf.py` (reference parity:
`RayMarch3.glsl:115-130`, `RayMarch.glsl:115-119,183-215`; plane, torus,
cylinder and capsule are the standard Inigo Quilez formulas).
"""
from __future__ import annotations

import torch

from .vecmath import Vec3


def sd_sphere(p: Vec3, centre: Vec3, radius):
    q = p - centre
    return q.length() - radius


def sd_box(p: Vec3, centre: Vec3, half_extent: Vec3):
    q = (p - centre).abs() - half_extent
    outside = q.maximum(0.0).length()
    inside = torch.clamp(q.max_component(), max=0.0)
    return inside + outside


def sd_plane(p: Vec3, normal: Vec3, offset):
    return p.dot(normal) - offset


def sd_torus(p: Vec3, centre: Vec3, major, minor):
    q = p - centre
    ql = torch.sqrt(q.x * q.x + q.z * q.z) - major
    return torch.sqrt(ql * ql + q.y * q.y) - minor


def sd_cylinder(p: Vec3, centre: Vec3, radius, half_height):
    q = p - centre
    dxz = torch.sqrt(q.x * q.x + q.z * q.z) - radius
    dy = torch.abs(q.y) - half_height
    mx = torch.clamp(dxz, min=0.0)
    my = torch.clamp(dy, min=0.0)
    out = torch.sqrt(mx * mx + my * my)
    return torch.clamp(torch.maximum(dxz, dy), max=0.0) + out


def sd_capsule(p: Vec3, a: Vec3, b: Vec3, radius):
    pa = p - a
    ba = b - a
    h = torch.clamp(pa.dot(ba) / torch.clamp(ba.dot(ba), min=1e-30), 0.0, 1.0)
    return (pa - ba * h).length() - radius


def smin(a, b, k):
    """Polynomial smooth min (`RayMarch.glsl:115-119`)."""
    h = torch.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return (b * (1.0 - h) + a * h) - k * h * (1.0 - h)


def domain_repeat(p: Vec3, m: Vec3) -> Vec3:
    """Per-axis mod-recentre (`RayMarch.glsl:199-215`); an axis with period
    0 passes through.  `torch.remainder` takes the divisor's sign, like
    `jnp.mod`."""

    def rep(c, period):
        nz = period != 0.0
        safe = torch.where(nz, period, 1.0)
        return torch.where(nz, torch.remainder(c, safe) - period * 0.5, c)

    return Vec3(rep(p.x, m.x), rep(p.y, m.y), rep(p.z, m.z))
