"""The object (SDF) node library as torch functions over Vec3.

Object nodes follow `RayMarch.glsl:121-215` and the JAX package's
`scene/nodes.py` op for op: every node takes its resolved JSON inputs
(the sample point arrives as the `-1` input) and returns a tuple holding
one vec3-valued register, the reference's `map_sphere(p, c, r, out vec3 d)`
convention.  The CUDA kernel interprets the same node set
(`csrc/mega_spectral.cu`, opcodes in `kernels/scene_program.py`).

Material node evaluation belongs to the RGB transport and is not ported
yet: the spectral transport reads only a material's index and whether its
graph reaches `shader_emission`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from raymarchrenderer_tpu_torch.core import sdf
from raymarchrenderer_tpu_torch.core.vecmath import Vec3


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

