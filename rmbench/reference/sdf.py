"""Signed distance primitives, CSG and domain operators over Vec3 tensors.

Op for op the JAX package's `core/sdf.py` (reference parity:
`RayMarch3.glsl:115-130`, `RayMarch.glsl:115-119,183-215`; plane, torus,
cylinder and capsule are the standard Inigo Quilez formulas).

The non-smooth ops take JAX's derivatives, so that `torch.autograd`
through the map (the exact normal of `normal_taps=0`, the march adjoint)
gives what `jax.grad` gives at their kinks.  `torch.minimum` and
`torch.maximum` split a tie 0.5 / 0.5 as `jnp.minimum` / `jnp.maximum`
do; they zero a losing input's cotangent where JAX multiplies it by 0,
which differs only for a cotangent of inf or NaN, and none of the
primitives here sends one into a min or max.  Where torch's own rule
differs at a kink that matters, a small Function keeps torch's value
bit for bit and takes JAX's derivative: `jclamp` splits a tie with its
bound 0.5 / 0.5 and passes the cotangent on by a multiply (inf * 0 is
NaN, as in `lax.max`'s jvp: inside a cylinder), where `torch.clamp`
gives 1 and masks; `jabs` has the derivative 1 at 0, where torch's
`abs` has 0.
"""
from __future__ import annotations

import torch

from rmbench.reference.vecmath import Vec3


def _balanced_eq(x, ans, y):
    """JAX's `_balanced_eq`: 1 where x is the result and y is not, 0.5
    where both are, 0 where x is not."""
    one = (x == ans).to(torch.float32)
    return one / torch.where(y == ans, 2.0, 1.0)


def _differentiated(*tensors) -> bool:
    """Whether autograd records an op on `tensors` (else the helpers below
    call torch's op directly: the same value, no Function to dispatch)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Clamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        out = torch.clamp(x, lo, hi)
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return out

    @staticmethod
    def backward(ctx, g):
        # jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi): the cotangent
        # meets the minimum first
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        m = x if lo is None else torch.clamp(x, min=lo)
        if hi is not None:
            g = g * _balanced_eq(m, torch.clamp(m, max=hi), hi)
        if lo is not None:
            g = g * _balanced_eq(x, m, lo)
        return g, None, None


def jclamp(x, lo=None, hi=None):
    """`torch.clamp(x, lo, hi)` with `jnp.clip`'s derivative (float
    bounds)."""
    if _differentiated(x):
        return _Clamp.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jabs(x):
    """`torch.abs` with `jnp.abs`'s derivative (1 at 0)."""
    if _differentiated(x):
        return _Abs.apply(x)
    return torch.abs(x)


def sd_sphere(p: Vec3, centre: Vec3, radius):
    q = p - centre
    return q.length() - radius


def sd_box(p: Vec3, centre: Vec3, half_extent: Vec3):
    d = p - centre
    q = Vec3(jabs(d.x), jabs(d.y), jabs(d.z)) - half_extent
    # at the outside clamps' tie (q = 0) the cotangent they pass on, the
    # length's 2 m g' with m = 0, is 0 already: torch's rule gives JAX's
    outside = q.maximum(0.0).length()
    inside = jclamp(q.max_component(), hi=0.0)
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
    dy = jabs(q.y) - half_height
    mx = jclamp(dxz, 0.0)
    my = jclamp(dy, 0.0)
    out = torch.sqrt(mx * mx + my * my)
    return jclamp(torch.maximum(dxz, dy), hi=0.0) + out


def sd_capsule(p: Vec3, a: Vec3, b: Vec3, radius):
    pa = p - a
    ba = b - a
    h = jclamp(pa.dot(ba) / jclamp(ba.dot(ba), 1e-30), 0.0, 1.0)
    return (pa - ba * h).length() - radius


def op_round(d, r):
    return d - r


def op_union(a, b):
    """`op_union`, `RayMarch.glsl:183-186`."""
    return torch.minimum(a, b)


def op_subtract(a, b):
    """`op_subtract`, `RayMarch.glsl:188-191`: max(a, -b)."""
    return torch.maximum(a, -b)


def op_intersect(a, b):
    """`op_intersect`, `RayMarch.glsl:193-196`."""
    return torch.maximum(a, b)


def op_union_mat(da, ma, db, mb):
    """Material-tagged union `opU` (`RayMarch3.glsl:127-130`): the tag of
    the nearer surface, a tie to b.  Returns (dist, matID)."""
    take_a = da < db
    return torch.where(take_a, da, db), torch.where(take_a, ma, mb)


def smin(a, b, k):
    """Polynomial smooth min (`RayMarch.glsl:115-119`):
    (b (1 - h) + a h) - (k h) (1 - h), h = clamp(0.5 + 0.5 (b - a) / k).

    The ops are created in the order that makes autograd sum h's four
    cotangents as the kernels' reverse sweep does (`grad_map`,
    csrc/scene_map.cuh: ((g a + gkh k) - g b) - grhs kh): autograd runs
    the later-created backward nodes first, so the product a h comes after
    the other three terms.  The values are the same ops on the same
    operands."""
    h = jclamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    omh_r = 1.0 - h
    omh_l = 1.0 - h
    b_omh = b * omh_l
    rhs = (k * h) * omh_r
    return (b_omh + a * h) - rhs


def domain_repeat(p: Vec3, m: Vec3) -> Vec3:
    """Per-axis mod-recentre (`RayMarch.glsl:199-215`); an axis with period
    0 passes through.  `torch.remainder` takes the divisor's sign, like
    `jnp.mod`."""

    def rep(c, period):
        nz = period != 0.0
        safe = torch.where(nz, period, 1.0)
        return torch.where(nz, torch.remainder(c, safe) - period * 0.5, c)

    return Vec3(rep(p.x, m.x), rep(p.y, m.y), rep(p.z, m.z))


def domain_translate(p: Vec3, t: Vec3) -> Vec3:
    return p - t


def domain_scale(p: Vec3, s) -> Vec3:
    return p / s
