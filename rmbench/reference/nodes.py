"""The node library: material and object nodes as torch functions over Vec3.

Material nodes follow the gen-1 shader library (`RayMarch.glsl:313-479`)
and, for the new scene format, the gen-2 BRDF library
(`RayMarch2.glsl:272-348`), op for op as in the JAX package's
`scene/nodes.py`: each takes a `ShadeCtx` and its resolved inputs and
draws its random numbers from the context's stream in a fixed order
(diffuse, glossy and refraction 2 each, volume 4, mix 1, the rest none).
Object nodes follow `RayMarch.glsl:121-215`: every node takes its resolved
JSON inputs (the sample point arrives as the `-1` input) and returns a
tuple holding one vec3-valued register, the reference's
`map_sphere(p, c, r, out vec3 d)` convention.

The CUDA kernels interpret the same node sets from compiled programs
(`kernels/scene_program.py`; objects in `csrc/scene_map.cuh`, materials in
`csrc/mega_paths.cu`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from rmbench.reference import sdf
from rmbench.reference.rng import RNGStream
from rmbench.reference.sampling import (
    cosine_hemisphere, ggx_lobe, make_tbn, tbn_apply,
    uniform_sphere_or_hemisphere)
from rmbench.reference.vecmath import (Vec3, reflect, refract,
                                                     vlerp, vselect)


class ShadeCtx:
    """Per-bounce shading context (`RayData` + `PointData`,
    `RayMarch.glsl:34-41`): `inside` is a float 0/1 mask, `normal` the SDF
    normal at the hit, `channels` the path's colour mask and `rng` the
    stream every node draws from."""

    __slots__ = ("origin", "dir", "t", "hit", "inside", "normal",
                 "channels", "rng")

    def __init__(self, origin: Vec3, dir: Vec3, t, hit: Vec3, inside,
                 normal: Vec3, channels: Vec3, rng: RNGStream):
        self.origin = origin
        self.dir = dir          # incident ray direction (into the surface)
        self.t = t
        self.hit = hit
        self.inside = inside
        self.normal = normal
        self.channels = channels
        self.rng = rng

    def grayscale(self, c: Vec3):
        """`grayscale` `RayMarch.glsl:306-309`: channel-mask-normalised mean."""
        return c.sum() / self.channels.sum()

    @property
    def wo(self) -> Vec3:
        """Toward-eye direction (`point.dir = -d`, RayMarch2.glsl:440)."""
        return -self.dir


class ShaderOut(NamedTuple):
    """A shader's bundle: (color, dir, inside, hit).  dir == 0 terminates
    the path; hit != 0 overrides the next ray origin (volume scatter)."""
    color: Vec3
    dir: Vec3
    inside: Vec3
    hit: Vec3


def _full(ctx: ShadeCtx, value: float):
    return torch.full(ctx.t.shape, value, dtype=torch.float32,
                      device=ctx.t.device)


def _zeros_like_ctx(ctx: ShadeCtx) -> Vec3:
    z = _full(ctx, 0.0)
    return Vec3(z, z, z)


def _white(ctx: ShadeCtx) -> Vec3:
    one = _full(ctx, 1.0)
    return Vec3(one, one, one)


# ---------------------------------------------------------------------------
# gen-1 material shader nodes (RayMarch.glsl:313-479) — old scene format
# ---------------------------------------------------------------------------

def shader_diffuse(ctx: ShadeCtx, color: Vec3):
    """Uniform-hemisphere bounce (`RayMarch.glsl:378-387`)."""
    out_dir = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                           ctx.normal)
    return color, out_dir


def shader_glossy(ctx: ShadeCtx, color: Vec3, roughness: Vec3):
    """lerp(hemisphere, mirror, 1 - roughness) (`RayMarch.glsl:389-398`);
    the mirror reflects about the normal flipped when inside."""
    hemi = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                        ctx.normal)
    n_f = ctx.normal * -(ctx.inside * 2.0 - 1.0)
    mirror = reflect(ctx.dir, n_f)
    w = 1.0 - ctx.grayscale(roughness * ctx.channels)
    return color, vlerp(hemi, mirror, w)


def shader_refraction(ctx: ShadeCtx, color: Vec3, ior: Vec3,
                      roughness: Vec3 = None):
    """Refraction with inside-tracking (`RayMarch.glsl:400-427`): entering
    refracts with 1/ior, white, inside := 1; exiting is tinted and lerps
    a diffuse bounce toward refract(-n, ior), inside := 0.  Total internal
    reflection gives the zero direction, which ends the path."""
    if roughness is None:
        roughness = _zeros_like_ctx(ctx)
    gs_ior = ctx.grayscale(ior * ctx.channels)
    enter_dir = refract(ctx.dir, ctx.normal, 1.0 / gs_ior)
    enter_dir = enter_dir.normalized() * (enter_dir.dot(enter_dir) > 0)
    r_dir = refract(ctx.dir, -ctx.normal, gs_ior)
    r_dir = r_dir.normalized() * (r_dir.dot(r_dir) > 0)
    d_dir = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                         ctx.normal)
    exit_dir = vlerp(d_dir, r_dir,
                     1.0 - ctx.grayscale(roughness * ctx.channels))
    is_in = ctx.inside > 0.5
    out_color = vselect(is_in, color, _white(ctx))
    out_dir = vselect(is_in, exit_dir, enter_dir)
    inv = 1.0 - ctx.inside
    return out_color, out_dir, Vec3(inv, inv, inv)


def shader_volume_scatter(ctx: ShadeCtx, color: Vec3, density: Vec3):
    """`shader_volumeScatter` (`RayMarch.glsl:429-474`) in closed form:
    scatter with probability 1 - (1-den)^floor(t*100) at a uniform
    position along the ray, den = grayscale(density)/20."""
    is_in = ctx.inside > 0.5
    den = ctx.grayscale(density * ctx.channels) / 20.0
    num_points = torch.floor(ctx.t * 100.0)
    p_scatter = 1.0 - torch.pow(torch.clamp(1.0 - den, min=0.0), num_points)
    u_evt = ctx.rng.next()
    u_pos = ctx.rng.next()
    scatters = is_in & (u_evt < p_scatter)
    hit_pos = ctx.origin + ctx.dir * (u_pos * ctx.t)
    scat_dir = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                            _zeros_like_ctx(ctx))
    one, zero = _full(ctx, 1.0), _full(ctx, 0.0)
    out_color = vselect(scatters, color, _white(ctx))
    out_dir = vselect(scatters, scat_dir, ctx.dir)
    # pass-through outside keeps inside=1 (the ray enters the volume);
    # an inside pass-through exits: inside=0 (RayMarch.glsl:459-473)
    inside_f = torch.where(scatters, one, torch.where(is_in, zero, one))
    out_hit = vselect(scatters, hit_pos, _zeros_like_ctx(ctx))
    return out_color, out_dir, Vec3(inside_f, inside_f, inside_f), out_hit


def shader_emission(ctx: ShadeCtx, color: Vec3, power: Vec3):
    """`shader_emission` (`RayMarch.glsl:476-479`): no direction, so the
    path ends."""
    return (color * ctx.grayscale(power * ctx.channels),)


def shader_mix(ctx: ShadeCtx, *args):
    """Stochastic select (`RayMarch.glsl:346-376`): 7 inputs
    (c1, d1, i1, c2, d2, i2, factor) -> (c, d, i), or 5 inputs
    (c1, d1, c2, d2, factor) -> (c, d); r < f takes branch 2."""
    if len(args) == 7:
        c1, d1, i1, c2, d2, i2, fac = args
    elif len(args) == 5:
        c1, d1, c2, d2, fac = args
        i1 = i2 = _zeros_like_ctx(ctx)
    else:
        raise ValueError(f"shader_mix expects 5 or 7 inputs, got {len(args)}")
    f = torch.clamp(ctx.grayscale(fac * ctx.channels), 0.0, 1.0)
    take2 = ctx.rng.next() < f
    out = (vselect(take2, c2, c1), vselect(take2, d2, d1),
           vselect(take2, i2, i1))
    return out if len(args) == 7 else out[:2]


def misc_facing(ctx: ShadeCtx):
    """clamp(dot(dir*(inside*2-1), normal), 0, 1) (`RayMarch.glsl:314-317`)."""
    s = ctx.inside * 2.0 - 1.0
    f = torch.clamp((ctx.dir * s).dot(ctx.normal), 0.0, 1.0)
    return (Vec3(f, f, f),)


def misc_inside(ctx: ShadeCtx):
    return (Vec3(ctx.inside, ctx.inside, ctx.inside),)


def misc_fresnel(ctx: ShadeCtx):
    """pow(1 - clamp(dot(normal, wo), 0, 1), 5) * 0.96 + 0.04
    (`Graphics.cpp:461`)."""
    c = torch.clamp(ctx.normal.dot(ctx.wo), 0.0, 1.0)
    f = torch.pow(1.0 - c, 5.0) * 0.96 + 0.04
    return (Vec3(f, f, f),)


def math_add(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x + n,)


def math_subtract(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x - n,)


def math_multiply(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x * n,)


def math_divide(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x / n,)


def math_sine(ctx: ShadeCtx, x: Vec3):
    return (Vec3(torch.sin(x.x), torch.sin(x.y), torch.sin(x.z)),)


def math_cosine(ctx: ShadeCtx, x: Vec3):
    return (Vec3(torch.cos(x.x), torch.cos(x.y), torch.cos(x.z)),)


# ---------------------------------------------------------------------------
# gen-2 BRDF/PDF shader nodes (RayMarch2.glsl:272-348) — new scene format
# ---------------------------------------------------------------------------

def shader_diffuse2(ctx: ShadeCtx, color: Vec3) -> ShaderOut:
    """Cosine-weighted sample through the TBN; weight = color
    (`RayMarch2.glsl:279-295`)."""
    local = cosine_hemisphere(ctx.rng.next(), ctx.rng.next())
    tbn = make_tbn(ctx.normal)
    return ShaderOut(color, tbn_apply(tbn, local), _zeros_like_ctx(ctx),
                     _zeros_like_ctx(ctx))


def shader_glossy2(ctx: ShadeCtx, color: Vec3, roughness: Vec3) -> ShaderOut:
    """GGX lobe through the TBN; roughness == 0 is the world-space mirror
    of the incident direction (`RayMarch2.glsl:326-347`)."""
    r = ctx.grayscale(roughness * ctx.channels)
    lobe = ggx_lobe(ctx.rng.next(), ctx.rng.next(), r)
    tbn = make_tbn(ctx.normal)
    rough_dir = tbn_apply(tbn, lobe)
    mirror = reflect(ctx.dir, ctx.normal)
    out_dir = vselect(r == 0.0, mirror, rough_dir)
    return ShaderOut(color, out_dir, _zeros_like_ctx(ctx),
                     _zeros_like_ctx(ctx))


def shader_mix2(ctx: ShadeCtx, a: ShaderOut, b: ShaderOut,
                factor: Vec3) -> ShaderOut:
    """New-format mix (`Graphics.cpp:426-457`): r <= f takes b."""
    f = torch.clamp(ctx.grayscale(factor * ctx.channels), 0.0, 1.0)
    take_b = ctx.rng.next() <= f
    return ShaderOut(vselect(take_b, b.color, a.color),
                     vselect(take_b, b.dir, a.dir),
                     vselect(take_b, b.inside, a.inside),
                     vselect(take_b, b.hit, a.hit))


MATERIAL_NODES: Dict[str, Callable] = {
    "shader_diffuse": shader_diffuse,
    "shader_glossy": shader_glossy,
    "shader_refraction": shader_refraction,
    "shader_volumeScatter": shader_volume_scatter,
    "shader_emission": shader_emission,
    "shader_mix": shader_mix,
    "misc_facing": misc_facing,
    "misc_inside": misc_inside,
    "misc_fresnel": misc_fresnel,
    "math_add": math_add,
    "math_subtract": math_subtract,
    "math_multiply": math_multiply,
    "math_divide": math_divide,
    "math_sine": math_sine,
    "math_cosine": math_cosine,
}


# ---------------------------------------------------------------------------
# object (SDF) nodes — RayMarch.glsl:121-215
# ---------------------------------------------------------------------------

def _splat(d) -> tuple:
    return (Vec3(d, d, d),)


def map_sphere(p: Vec3, centre: Vec3, radius: Vec3):
    return _splat(sdf.sd_sphere(p, centre, radius.x))


def map_box(p: Vec3, centre: Vec3, radius: Vec3):
    return _splat(sdf.sd_box(p, centre, radius))


def map_plane(p: Vec3, normal: Vec3, offset: Vec3):
    return _splat(sdf.sd_plane(p, normal.normalized(), offset.x))


def map_torus(p: Vec3, centre: Vec3, radii: Vec3):
    return _splat(sdf.sd_torus(p, centre, radii.x, radii.y))


def map_cylinder(p: Vec3, centre: Vec3, size: Vec3):
    return _splat(sdf.sd_cylinder(p, centre, size.x, size.y))


def map_capsule(p: Vec3, a: Vec3, b: Vec3, radius: Vec3):
    return _splat(sdf.sd_capsule(p, a, b, radius.x))


def op_union(a: Vec3, b: Vec3):
    return (Vec3(*(torch.minimum(ca, cb) for ca, cb in zip(a, b))),)


def op_subtract(a: Vec3, b: Vec3):
    return (Vec3(*(torch.maximum(ca, -cb) for ca, cb in zip(a, b))),)


def op_intersect(a: Vec3, b: Vec3):
    return (Vec3(*(torch.maximum(ca, cb) for ca, cb in zip(a, b))),)


def op_smooth_union(a: Vec3, b: Vec3, k: Vec3):
    return _splat(sdf.smin(a.x, b.x, k.x))


def domain_repeat(p: Vec3, m: Vec3):
    return (sdf.domain_repeat(p, m),)


def misc_getX(v: Vec3):
    return _splat(v.x)


def misc_getY(v: Vec3):
    return _splat(v.y)


def misc_getZ(v: Vec3):
    return _splat(v.z)


def obj_math_add(x: Vec3, n: Vec3):
    return (x + n,)


def obj_math_subtract(x: Vec3, n: Vec3):
    return (x - n,)


def obj_math_multiply(x: Vec3, n: Vec3):
    return (x * n,)


def obj_math_divide(x: Vec3, n: Vec3):
    return (x / n,)


def obj_math_sine(x: Vec3):
    return (Vec3(torch.sin(x.x), torch.sin(x.y), torch.sin(x.z)),)


def obj_math_cosine(x: Vec3):
    return (Vec3(torch.cos(x.x), torch.cos(x.y), torch.cos(x.z)),)


OBJECT_NODES: Dict[str, Callable] = {
    "map_sphere": map_sphere,
    "map_box": map_box,
    "map_plane": map_plane,
    "map_torus": map_torus,
    "map_cylinder": map_cylinder,
    "map_capsule": map_capsule,
    "op_union": op_union,
    "op_subtract": op_subtract,
    "op_intersect": op_intersect,
    "op_smooth_union": op_smooth_union,
    "domain_repeat": domain_repeat,
    "misc_getX": misc_getX,
    "misc_getY": misc_getY,
    "misc_getZ": misc_getZ,
    "math_add": obj_math_add,
    "math_subtract": obj_math_subtract,
    "math_multiply": obj_math_multiply,
    "math_divide": obj_math_divide,
    "math_sine": obj_math_sine,
    "math_cosine": obj_math_cosine,
}

