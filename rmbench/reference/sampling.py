"""Direction sampling: uniform sphere / hemisphere, cosine-weighted, GGX.

  * `randHemisphere` (`RayMarch3.glsl:202-236`): a uniform sphere point via
    theta = 2*pi*u1, phi = acos(2*u2 - 1), flipped so z >= 0 and rotated
    into the normal's frame built by `makeViewMat` (locZ = normal).  A zero
    normal returns the raw uniform-sphere direction.
  * `makeTBN` (`RayMarch3.glsl:182-200`): tangent = normalize(cross(up, n))
    with a (1,0,0) fallback when n.x == 0; columns (bitangent, normal,
    tangent), so a y-up sample maps its y onto the normal.
  * `DiffuseMaterial.samplePDF` (`RayMarch2.glsl:279-290`): cosine-weighted
    about +Y; `GlossyMaterial.samplePDF` (`:326-342`): a GGX lobe about +Y
    with alpha = roughness^2.

Same op order as the JAX package's `core/sampling.py`; `torch.sin`/`cos`
differ from XLA:CPU's by 1 ulp in a few percent of inputs.
"""
from __future__ import annotations

import torch

from rmbench.reference.vecmath import Vec3, make_onb, reflect, vselect

_PI = 3.14159265358979323846


def uniform_sphere(u1, u2) -> Vec3:
    theta = 2.0 * _PI * u1
    cos_phi = 2.0 * u2 - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    return Vec3(sin_phi * torch.cos(theta), cos_phi,
                sin_phi * torch.sin(theta))


def uniform_hemisphere(u1, u2, normal: Vec3) -> Vec3:
    """`randHemisphere`: a uniform sphere point flipped to z >= 0, then
    rotated into the normal's `make_onb` frame."""
    b = uniform_sphere(u1, u2)
    b = vselect(b.z < 0.0, -b, b)
    x, y, z = make_onb(normal)
    return x * b.x + y * b.y + z * b.z


def uniform_sphere_or_hemisphere(u1, u2, normal: Vec3) -> Vec3:
    """randHemisphere including the zero-normal pass-through branch."""
    b = uniform_sphere(u1, u2)
    zero_n = (normal.x == 0.0) & (normal.y == 0.0) & (normal.z == 0.0)
    bh = vselect(b.z < 0.0, -b, b)
    x, y, z = make_onb(normal)
    rotated = x * bh.x + y * bh.y + z * bh.z
    return vselect(zero_n, b, rotated)


# constant axes of make_tbn: Python floats keep the cross product's
# arithmetic identical to the JAX package's full-array constants
_UP = Vec3(0.0, 1.0, 0.0)
_FALLBACK = Vec3(1.0, 0.0, 0.0)


def make_tbn(normal: Vec3) -> tuple[Vec3, Vec3, Vec3]:
    """(bitangent, normal, tangent) columns of `makeTBN`; the reference's
    exact `normal.x == 0` test picks the (1,0,0) tangent."""
    crossed = _UP.cross(normal)
    shape = normal.x.shape
    fallback = Vec3(*(torch.full(shape, c, dtype=torch.float32,
                                 device=normal.x.device) for c in _FALLBACK))
    tangent = vselect(normal.x == 0.0, fallback, crossed.normalized())
    bitangent = tangent.cross(normal).normalized()
    return bitangent, normal, tangent


def tbn_apply(tbn, local: Vec3) -> Vec3:
    b, n, t = tbn
    return b * local.x + n * local.y + t * local.z


def cosine_hemisphere(u1, u2) -> Vec3:
    """Cosine-weighted about +Y (`DiffuseMaterial.samplePDF`)."""
    sin2 = u1
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
    sin_t = torch.sqrt(sin2)
    o = u2 * 2.0 * _PI
    return Vec3(sin_t * torch.cos(o), cos_t, sin_t * torch.sin(o)).normalized()


def ggx_lobe(u1, u2, roughness) -> Vec3:
    """GGX NDF sample about +Y, alpha = roughness^2; the sqrt arguments are
    floored at 1e-12 as in the JAX package."""
    a = roughness * roughness
    o = u1 * 2.0 * _PI
    r = u2
    denom = (a * a - 1.0) * r + 1.0
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - r) / torch.clamp(denom, min=1e-12), 1e-12, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    return Vec3(sin_t * torch.cos(o), cos_t, sin_t * torch.sin(o)).normalized()


def glossy_sample(u1, u2, wo: Vec3, normal: Vec3, roughness) -> Vec3:
    """A glossy direction in the local y-up frame, with the reference's
    roughness == 0 mirror case (`RayMarch2.glsl:328-331`): reflect(wo, n)
    there, the GGX lobe elsewhere."""
    lobe = ggx_lobe(u1, u2, roughness)
    mirror = reflect(wo, normal)
    smooth = torch.as_tensor(roughness, dtype=torch.float32,
                             device=lobe.x.device) == 0.0
    return vselect(smooth, mirror, lobe)


def fresnel_schlick(cos_theta, f0=0.04, scale=0.96, power=5.0):
    """`misc_fresnel` (`Graphics.cpp:461`):
    pow(1 - clamp(cos, 0, 1), 5) * 0.96 + 0.04."""
    c = torch.clamp(cos_theta, 0.0, 1.0)
    return torch.pow(1.0 - c, power) * scale + f0
