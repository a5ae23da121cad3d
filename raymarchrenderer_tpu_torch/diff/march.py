"""Differentiable sphere tracing: the reparameterized (implicit-function)
march adjoint of the JAX package's `diff/march.py`, under torch autograd.

The march itself is never differentiated.  The converged hit distance
t*(theta, o, d) satisfies f(o + t* d; theta) = 0 for the scene SDF f, so

    dt*/dtheta = -f_theta / (grad f . d),  dt*/do = -grad f / (grad f . d),
    dt*/dd = -t* grad f / (grad f . d)

at the (detached) hit point, and `reparam_t` attaches exactly these
derivatives to the detached t with a zero-valued surrogate:

    t_out = t - (f(o + d t; theta) - f.detach()) * inv,
    inv = 1 / (grad f . d) detached (0 where invalid or ill-conditioned)

whose value is t bitwise.  Missed lanes get no gradient.  The marches run
detached and without a graph (the plain `render.integrator.march`, the
CUDA kernel `march_fused`, or the recorded banks), so a backward pass
never meets a march loop.

JAX tags the march outputs with `checkpoint_name` so that its remat policy
keeps them; here the train step's `torch.utils.checkpoint` takes the
recorded banks as inputs instead (`parallel/sharding.py`), and
`checkpoint_name` has no counterpart.
"""
from __future__ import annotations

import torch

from raymarchrenderer_tpu_torch.core.vecmath import Vec3


def _keep(x):
    return x


def _leaves(tree):
    """The tensors of a nested dict / list parameter tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _detached_tree(tree):
    if isinstance(tree, dict):
        return {k: _detached_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached_tree(v) for v in tree]
    return tree.detach()


def _surface_gradient(scene, cfg, params, p: Vec3) -> Vec3:
    """grad f at the detached points `p` by one reverse sweep of the map
    over detached copies, with no graph left behind.  The sweep keeps its
    own saved tensors (identity hooks), so it also runs inside a region of
    `torch.utils.checkpoint` and under `torch.no_grad()`."""
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            _keep, _keep):
        q = Vec3(*(c.detach().requires_grad_(True) for c in p))
        f = scene.map_dist(_detached_tree(params), q, cfg.max_dist)
        # a scene without objects: a constant map, a zero gradient
        g = (torch.autograd.grad(f, tuple(q), torch.ones_like(f),
                                 allow_unused=True) if f.requires_grad
             else (None,) * 3)
    return Vec3(*(torch.zeros_like(c) if gc is None else gc
                  for gc, c in zip(g, p)))


def reparam_t(scene, cfg, params, o: Vec3, d: Vec3, t, valid):
    """The detached hit distance `t` with implicit-function gradients
    attached: equal to `t` bitwise, with derivatives -f_theta/(grad f . d),
    -grad f/(grad f . d) and -t grad f/(grad f . d) w.r.t. the scene
    parameters, `o` and `d` where `valid` and |grad f . d| > 1e-6, and zero
    elsewhere."""
    t_sg = t.detach()
    o_sg = Vec3(*(c.detach() for c in o))
    d_sg = Vec3(*(c.detach() for c in d))
    g = _surface_gradient(scene, cfg, params, o_sg + d_sg * t_sg)
    denom = g.x * d_sg.x + g.y * d_sg.y + g.z * d_sg.z
    safe = valid & (torch.abs(denom) > 1e-6)
    inv = torch.where(safe, 1.0 / torch.where(safe, denom, 1.0), 0.0)
    # the differentiable SDF residual at the detached hit point: value 0,
    # derivatives (f_theta, grad f, t grad f) through p = o + d * t
    f = scene.map_dist(params, o + d * t_sg, cfg.max_dist)
    return t_sg - (f - f.detach()) * inv.detach()


def march_diff(scene, cfg, params, o: Vec3, d: Vec3, dist_mult, active):
    """`render.integrator.march` with gradients: (t, material index, hit
    mask), t carrying the implicit-function gradients."""
    from raymarchrenderer_tpu_torch.render.integrator import march
    with torch.no_grad():
        t, mid, hitm = march(scene, params, cfg, o, d, dist_mult, active)
    return reparam_t(scene, cfg, params, o, d, t, hitm & active), mid, hitm


def march_diff_fused(scene, cfg, params, o: Vec3, d: Vec3, dist_mult,
                     active):
    """`march_diff` with the forward march on `kernels.march.march_fused`
    (the CUDA kernel for CUDA tensors) and the same adjoint."""
    from raymarchrenderer_tpu_torch.kernels.march import march_fused
    with torch.no_grad():
        t, mid, hitm = march_fused(scene, params, cfg, o, d, dist_mult,
                                   active)
    return reparam_t(scene, cfg, params, o, d, t, hitm & active), mid, hitm


def march_diff_recorded(scene, cfg, params, o: Vec3, d: Vec3, active,
                        rec_t, rec_mid, rec_hit):
    """The recorded forward: the march already ran in the recording
    megakernel (`kernels.record.trace_record_fused`); attach the adjoint
    to its banked (t, mid, hit) planes."""
    hitm = rec_hit > 0
    return (reparam_t(scene, cfg, params, o, d, rec_t, hitm & active),
            rec_mid, hitm)
