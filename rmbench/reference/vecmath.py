"""Vector math on structure-of-arrays Vec3 over torch tensors.

Rays, normals and colours are three separate float32 tensors of the batch
shape rather than one tensor with a trailing size-3 axis, exactly like the
JAX package's `core/vecmath.py`, so every function reads op for op like its
counterpart there.  A component may also be a 0-d tensor (a scene
parameter) or a Python float (a constant); broadcasting does the rest.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """Structure-of-arrays 3-vector; components broadcast like tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(self.y * o.z - self.z * o.y,
                    self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def length(self):
        return torch.sqrt(torch.clamp(self.dot(self), min=1e-24))

    def normalized(self) -> "Vec3":
        # 1/sqrt, both correctly rounded (on the CPU and in the CUDA
        # kernel alike).  The JAX package calls lax.rsqrt, which on XLA:CPU
        # differs from this by 1 ulp in about a third of inputs.
        inv = 1.0 / torch.sqrt(torch.clamp(self.dot(self), min=1e-24))
        return self * inv

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def sum(self):
        return self.x + self.y + self.z

    def abs(self) -> "Vec3":
        return Vec3(torch.abs(self.x), torch.abs(self.y), torch.abs(self.z))

    def maximum(self, lo: float) -> "Vec3":
        return Vec3(torch.clamp(self.x, min=lo), torch.clamp(self.y, min=lo),
                    torch.clamp(self.z, min=lo))

    def stack(self, dim: int = -1) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=dim)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a Python number c, rounded as the CPU and the CUDA kernels
    round it on every device: torch's CUDA build divides a tensor by a
    Python number as a product with its reciprocal, an ulp off for some
    quotients (the plain recorder's drift on the card), so c goes in as a
    tensor on x's device, which that build divides by."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def vselect(mask, a: Vec3, b: Vec3) -> Vec3:
    """Per-component torch.where over Vec3."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def vlerp(a: Vec3, b: Vec3, t) -> Vec3:
    """GLSL mix(a, b, t) = a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect: d - 2*dot(d,n)*n (d points *into* the surface)."""
    return d - n * (2.0 * d.dot(n))


def refract(d: Vec3, n: Vec3, eta) -> Vec3:
    """GLSL refract(I, N, eta); the zero vector on total internal
    reflection.  The sqrt argument is floored at 1e-12, as in the JAX
    package (which keeps its adjoint finite there)."""
    cosi = -d.dot(n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    k = torch.clamp(k, min=1e-12)
    out = d * eta + n * (eta * cosi - torch.sqrt(k))
    zero = torch.zeros_like(k)
    return vselect(tir, Vec3(zero, zero, zero), out)


def rotate_axis(u: Vec3, t, p: Vec3) -> Vec3:
    """Rotation of p about the unit axis u by the angle t, in the reference
    camera's handedness (`Camera.cpp:31-52`): glm's column-major mat3
    applies the transpose of Rodrigues' matrix, so the cross term's sign is
    flipped, p ct - (u x p) st + u (u.p)(1 - ct), as in the JAX package.
    This is the observed mapping, not a slip to correct."""
    if not torch.is_tensor(t):
        t = torch.tensor(t, dtype=torch.float32,
                         device=p.x.device if torch.is_tensor(p.x) else None)
    ct = torch.cos(t)
    st = torch.sin(t)
    return p * ct - u.cross(p) * st + u * (u.dot(p) * (1.0 - ct))


# constant axes for make_onb: Python floats keep the cross products'
# arithmetic identical to the JAX package's full-array constants
_UP = Vec3(0.0, 1.0, 0.0)
_ALT = Vec3(0.0, 0.0, 1.0)


def make_onb(n: Vec3) -> tuple[Vec3, Vec3, Vec3]:
    """Orthonormal basis around n (`makeViewMat`, `RayMarch3.glsl:63-80`):
    x = normalize(n x up), with n x (0,0,1) where |n x up|^2 < 1e-12;
    y = normalize(n x x)."""
    c1 = n.cross(_UP)
    c2 = n.cross(_ALT)
    degenerate = c1.dot(c1) < 1e-12
    x = vselect(degenerate, c2, c1).normalized()
    y = n.cross(x).normalized()
    return x, y, n


def atan2_poly(y, x):
    """Polynomial atan2 (max error ~1e-6 rad) of float32 tensors, op for op
    the JAX package's `vecmath.atan2_poly` (an odd minimax polynomial of
    atan on [0, 1] and quadrant folding), which the deferred-sky
    megakernel uses to pack a miss direction's equirect (u, v); the CUDA
    kernel repeats it op for op (`csrc/mega_paths.cu` `atan2_poly`)."""
    pi = 3.14159265358979
    half_pi = 1.5707963267949
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    r = lo / torch.clamp(hi, min=1e-30)
    s = r * r
    a = (((((-0.0117212 * s + 0.05265332) * s - 0.11643287) * s
           + 0.19354346) * s - 0.33262347) * s + 0.99997726) * r
    a = torch.where(ay > ax, half_pi - a, a)
    a = torch.where(x < 0, pi - a, a)
    return torch.where(y < 0, -a, a)
