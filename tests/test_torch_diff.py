"""Port parity, the differentiable path: `diff.march.reparam_t` (the
implicit-function march adjoint under torch autograd) and
`render_patch_spp(differentiable=True)` for the three march
implementations, against `jax.grad` of the JAX package.

Bars: the reparameterized t equals the march's t bitwise; its gradients
match JAX's to 1e-5 relative.  The differentiable render's loss matches
to rtol 1e-5 and every leaf's gradient to atol 1e-4 * max|g| (the JAX
package's own oracle-vs-recorded bars are bitwise without NEE,
tests/test_diff.py; across frameworks sqrt, sin, cos and rsqrt are 1 ulp
apart, ROADMAP Queue 3).  Inside the port, the gradients with remat equal
those without it bitwise, as tests/test_diff.py holds for JAX.  NEE and
Russian roulette: tests/test_torch_diff_nee.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_grads import assert_grads_close, jax_loss_grads, port_loss_grads
from _torch_parity import corners_to_torch, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.diff import march as jdiff
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.diff import march as tdiff
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.integrator import (
    march as tmarch_plain)
from raymarchrenderer_tpu_torch.scene import (builtin as tbuiltin,
                                              param_leaves,
                                              params_from_numpy,
                                              params_replace)

_CFG = dict(width=64, height=32, spp=1, max_steps=96, max_bounces=3,
            max_dist=100.0)


def _planes(a, k):
    return tuple(np.ascontiguousarray(a[..., i]) for i in range(k))


def _head_on(oz=-5.0, y=1.0):
    """A (1, 1) ray at (0, y, oz) along +z."""
    o = np.float32([[[0.0, y, oz]]])
    d = np.float32([[[0.0, 0.0, 1.0]]])
    return o, d


def test_reparam_value_is_t_and_dt_dradius():
    """Head-on at the unit sphere at (0, 1, 0): t = 5 - r, so dt/dr = -1
    (tests/test_diff.py:42); the surrogate's value is the march's t."""
    scene = tbuiltin.single_sphere()
    cfg = TCfg(width=8, height=8, max_steps=256, max_bounces=2,
               max_dist=100.0)
    base = scene.init_params("cpu")
    r = torch.tensor(1.0, requires_grad=True)
    params = params_replace(base, [
        r.expand(3) if leaf is base["objects"][0][1] else leaf
        for leaf in param_leaves(base)])
    o, d = _head_on()
    to = TVec3(*(torch.from_numpy(c) for c in _planes(o, 3)))
    td = TVec3(*(torch.from_numpy(c) for c in _planes(d, 3)))
    ones = torch.ones((1, 1))
    act = torch.ones((1, 1), dtype=torch.bool)
    t, _, hit = tdiff.march_diff(scene, cfg, params, to, td, ones, act)
    t0, _, _ = tmarch_plain(scene, base, cfg, to, td, ones, act)
    assert bool(hit.all()) and torch.equal(t.detach(), t0)
    assert abs(float(t.detach()) - 4.0) < 0.05
    (g,) = torch.autograd.grad(t.sum(), r)
    assert abs(float(g) + 1.0) < 1e-3


@pytest.mark.parametrize("relax", [0.0, 1.9], ids=["classic", "relaxed"])
def test_reparam_grads_match_jax(relax):
    """d(sum t * w)/d(params, o, d) over 48 seeded rays at sphere_on_floor
    (a quarter aimed at the sky miss): against jax.grad of the JAX
    package's `march_diff` (measured max relative difference 1.2e-7)."""
    rng = np.random.RandomState(3)
    o = (np.float32([0.0, 4.0, -6.0])
         + rng.uniform(-0.2, 0.2, (6, 8, 3))).astype(np.float32)
    d = np.float32([0.0, -3.0, 6.0]) + rng.uniform(-2.0, 2.0, (6, 8, 3))
    up = rng.uniform(size=(6, 8)) < 0.25        # these miss into the sky
    d[..., 1] = np.where(up, np.abs(d[..., 1]) + 0.5, d[..., 1])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (6, 8)).astype(np.float32)
    kw = dict(width=8, height=6, max_steps=128, max_dist=100.0,
              relax_omega=relax)
    js, ts = jbuiltin.sphere_on_floor(), tbuiltin.sphere_on_floor()
    jp = js.init_params()

    def jloss(p, o_, d_):
        t, _, _ = jdiff.march_diff(
            js, JCfg(**kw), p, JVec3(*o_), JVec3(*d_),
            jnp.ones((6, 8), jnp.float32), jnp.ones((6, 8), bool))
        return jnp.sum(t * w)

    jo, jd = _planes(o, 3), _planes(d, 3)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, tuple(map(jnp.asarray, jo)), tuple(map(jnp.asarray, jd)))
    tp = params_from_numpy(np_tree(jp), "cpu")
    leaves = [leaf.requires_grad_(True) for leaf in param_leaves(tp)]
    to = [torch.from_numpy(c).requires_grad_(True) for c in jo]
    td = [torch.from_numpy(c).requires_grad_(True) for c in jd]
    t, _, hit = tdiff.march_diff(ts, TCfg(**kw), tp, TVec3(*to), TVec3(*td),
                                 torch.ones((6, 8)),
                                 torch.ones((6, 8), dtype=torch.bool))
    assert 0 < int(hit.sum()) < 48
    tg = torch.autograd.grad((t * torch.from_numpy(w)).sum(),
                             leaves + to + td, allow_unused=True)
    want = jax.tree.leaves(jg[0]) + list(jg[1]) + list(jg[2])
    assert len(want) == len(tg)
    for a, b in zip(want, tg):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = max(1e-6, float(np.abs(a).max(initial=0.0)))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def sphere_case():
    """sphere_on_floor at tests/test_diff.py's recorded setup (64 x 32,
    3 bounces, 2 samples) and the JAX reference: its recorded path, which
    that file holds bitwise equal to its oracle and fused paths."""
    js, ts = jbuiltin.sphere_on_floor(), tbuiltin.sphere_on_floor()
    jp = js.init_params()
    corners = JCamera(aspect=2.0).corner_rays_flat()
    want = jax_loss_grads(js, jp, JCfg(**_CFG), corners, "recorded", False,
                          (32, 64), 2)
    return (ts, params_from_numpy(np_tree(jp), "cpu"), TCfg(**_CFG),
            corners_to_torch(corners), want)


@pytest.mark.parametrize("impl", ["oracle", "fused", "recorded"])
def test_render_grads_match_jax(sphere_case, impl):
    """Measured: loss relative difference below 1e-7 and leaf gradients
    within 1e-6 * max|g| for each implementation."""
    ts, tp, cfg, corners, want = sphere_case
    got = port_loss_grads(ts, tp, cfg, corners, impl, False, (32, 64), 2)
    assert any(float(np.abs(g).max(initial=0.0)) > 0 for g in got[1])
    assert_grads_close(want, got, 1e-4)


@pytest.mark.parametrize("impl", ["fused", "recorded"])
def test_remat_grads_equal_no_remat(sphere_case, impl):
    """torch.utils.checkpoint over the render recomputes the shading in
    the backward pass; the gradients are bitwise those without it."""
    ts, tp, cfg, corners, _ = sphere_case
    plain = port_loss_grads(ts, tp, cfg, corners, impl, False, (32, 64), 2)
    remat = port_loss_grads(ts, tp, cfg, corners, impl, False, (32, 64), 2,
                              remat=True)
    assert plain[0] == remat[0]
    for a, b in zip(plain[1], remat[1]):
        np.testing.assert_array_equal(a, b)
