"""Shared harness of the differentiable path's parity tests
(`test_torch_diff*.py`): the loss sum(render_patch_spp ** 2) and its
gradient with respect to every parameter leaf, in the JAX package
(`jax.value_and_grad`, Pallas kernels in interpret mode) and in the port
(torch autograd), on the same numpy parameters."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.utils.checkpoint

from _torch_parity import corners_to_torch, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.integrator import (
    render_patch_spp as jrender_patch_spp)
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.integrator import render_patch_spp
from raymarchrenderer_tpu_torch.scene import (param_leaves, params_from_numpy,
                                              params_replace)


def case(js, cfg_kw, camera_kw):
    """The JAX params, config and corners, and the port's twins."""
    jp = js.init_params()
    corners = JCamera(**camera_kw).corner_rays_flat()
    return (jp, JCfg(**cfg_kw), corners, params_from_numpy(np_tree(jp), "cpu"),
            TCfg(**cfg_kw), corners_to_torch(corners))


def port_loss_grads(scene, params, cfg, corners, impl, direct_light,
                    shape, spp, remat=False):
    """(loss, leaf grads) of sum(render_patch_spp ** 2) in the port."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in param_leaves(params)]
    fit = params_replace(params, leaves)

    def f(fit):
        return render_patch_spp(scene, fit, cfg, corners, (0, 0), shape, 0,
                                spp, direct_light, differentiable=True,
                                march_impl=impl).stack(-1)

    c = (torch.utils.checkpoint.checkpoint(f, fit, use_reentrant=False)
         if remat else f(fit))
    loss = torch.sum(c ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [
        np.zeros(tuple(leaf.shape), np.float32) if g is None else g.numpy()
        for g, leaf in zip(grads, leaves)]


def jax_loss_grads(js, jp, cfg, corners, impl, direct_light, shape, spp):
    """(loss, leaf grads) of the same loss in the JAX package."""
    def loss(params):
        c = jrender_patch_spp(js, params, cfg, corners, (0, 0), shape,
                              jnp.uint32(0), spp, direct_light=direct_light,
                              differentiable=True, march_impl=impl,
                              interpret=True)
        return jnp.sum(c.stack(-1) ** 2)
    value, grads = jax.value_and_grad(loss)(jp)
    return float(value), [np.asarray(g) for g in jax.tree.leaves(grads)]


def assert_grads_close(want, got, rel_atol, loss_rtol=1e-5):
    """Loss to `loss_rtol`; each leaf to atol rel_atol * max|g| of the
    leaf."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    assert len(want[1]) == len(got[1])
    for a, b in zip(want[1], got[1]):
        assert a.shape == b.shape
        np.testing.assert_allclose(
            b, a, rtol=0,
            atol=rel_atol * max(1e-6, float(np.abs(a).max(initial=0.0))))
