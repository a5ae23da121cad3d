"""Shared harness of the env-sky parity tests (`test_torch_env_render.py`,
`test_torch_env_patch.py`, `test_torch_train_env.py`,
`test_torch_train_sh.py`): scenes under an equirect env image in both
packages, their configurations, the JAX package's oracle mean, and the
train loss's gradients in both packages."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import corners_to_torch, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.integrator import (
    render_patch_spp as jrender_patch_spp)
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.parallel import sharding as tsharding
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import param_leaves, params_from_numpy

STRICT = dict(lazy_miss=False, march_unroll=4, regen_cadence=0)
PRODUCTION = dict(lazy_miss=True, march_unroll=32, regen_cadence=16)


def env_image(h=8, w=16, seed=7):
    return np.random.RandomState(seed).uniform(
        0.0, 2.0, (h, w, 3)).astype(np.float32)


def env_scenes(kind, img):
    """(JAX scene, port scene) under the env image: "ball" a diffuse ball
    on a box, "glass" a glass ball on a box, "nee" the ball and a sphere
    light."""
    out = []
    for b in (jbuiltin.SceneBuilder(), tbuiltin.SceneBuilder()):
        m = b.diffuse([0.6, 0.5, 0.4])
        if kind == "glass":
            b.sphere(b.glass([0.9, 0.95, 1.0], ior=1.45), [0.0, 1.0, 0.0],
                     1.0)
        else:
            b.sphere(m, [0.0, 1.0, 0.0], 1.0)
        b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
        if kind == "nee":
            b.light([3, 7, -3], 60.0, 0.8)
        out.append(b.build(env_image=img))
    return tuple(out)


def case(kind, w=24, h=16, img=None, **cfg_kw):
    """(js, jp, jcfg, jcorners, ts, tp, tcfg, tcorners)."""
    js, ts = env_scenes(kind, env_image() if img is None else img)
    jp = js.init_params()
    kw = dict(dict(width=w, height=h, max_steps=96, max_bounces=3,
                   max_dist=100.0), **cfg_kw)
    corners = JCamera(aspect=w / h).corner_rays_flat()
    return (js, jp, JCfg(**kw), corners, ts,
            params_from_numpy(np_tree(jp), "cpu"), TCfg(**kw),
            corners_to_torch(corners))


def jax_oracle(js, jp, cfg, corners, origin, shape, samples, direct_light):
    """The JAX package's oracle: the per-pixel mean of `render_patch` over
    `samples` (exact sky), (ph, pw, 3)."""
    f = jax.jit(lambda p, s: jint.render_patch(
        js, p, cfg, corners, origin, shape, s,
        direct_light=direct_light).stack(-1))
    return sum(np.asarray(f(jp, jnp.uint32(s))) for s in samples) / len(
        samples)


_TARGET = np.random.RandomState(5).uniform(0.0, 0.8, (16, 24, 3)).astype(
    np.float32)


def jax_train_grads(js, jp, cfg, corners, spp):
    """The JAX package's train loss, sum((mean - target)^2) / (H W 3),
    and its gradient per leaf (oracle march, differentiable)."""
    def loss(params):
        c = jrender_patch_spp(js, params, cfg, corners, (0, 0),
                              (cfg.height, cfg.width), jnp.uint32(0), spp,
                              differentiable=True)
        img = c.stack(-1) / float(spp)
        return jnp.sum((img - _TARGET) ** 2) / float(
            cfg.height * cfg.width * 3)
    value, grads = jax.value_and_grad(loss)(jp)
    return float(value), [np.asarray(g) for g in jax.tree.leaves(grads)]


def assert_grads_close(want, got, rel_atol):
    """The loss to rtol 1e-5, leaf i's gradient to atol rel_atol[i] *
    max|g| of the leaf."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert len(want[1]) == len(got[1]) == len(rel_atol)
    for a, b, r in zip(want[1], got[1], rel_atol):
        assert a.shape == b.shape
        np.testing.assert_allclose(
            b, a, rtol=0, atol=r * max(1e-6, float(np.abs(a).max(initial=0.0))))


def port_train_grads(ts, tp, tcfg, tc, spp, impl):
    loss, grads = tsharding.train_grads_sharded(
        ts, tp, tcfg, tc, torch.from_numpy(_TARGET), spp, march_impl=impl)
    return float(loss), [g.numpy() for g in param_leaves(grads)]
