"""Render and train over the device layout: the JAX package's
`parallel/sharding.py` for one device.

The JAX package lays a frame over a ('tile', 'spp') mesh (pixel rows x
sample slices, merged by psum).  This slice ports the one-device layout,
tile = spp = 1, with the same functions minus the mesh; a `ShardConfig`
of more devices raises (the sharding slice, ROADMAP Queue 1 item 7).

  * `render_sharded` — the mean image of `spp` samples: the RGB
    megakernel (`impl="fused"`, one launch) or the oracle;
  * `train_step_sharded` — one inverse-rendering SGD step: the
    differentiable render (`render_patch_spp(differentiable=True)`), the
    pixel L2 loss sum((acc / spp - target)^2) / (H * W * 3), gradients to
    every parameter leaf by autograd (a leaf the loss does not reach gets
    zeros), and p - lr * g on every leaf;
  * `train_grads_sharded` — its loss and gradients, without the update;
  * `train_loss_sharded` — its forward alone (no graph);
  * `render_sharded_spectral` — the mean spectral image, one launch of the
    spectral megakernel;
  * `train_step_spectral_sharded` — one spectral inverse-rendering step
    (`train --spectral`): the soft-band differentiable render
    (`render_patch_spp_spectral(differentiable=True)`), the same loss, SGD
    on the scene parameters and a sign step on the band rows (min and max
    wavelength, power), clamped to the visible range by `_clamp_bands`;
    split, as the RGB step is, into `train_grads_spectral_sharded`,
    `train_loss_spectral_sharded` and `spectral_update`.

`remat=True` (the default, as in the JAX package) runs the trace under
`torch.utils.checkpoint`: the backward pass recomputes the shading chain
from its inputs instead of keeping every intermediate plane.  With
`march_impl="recorded"` (the train CLI's default) the recorder's banks are
an input of the checkpointed replay, so the backward pass never relaunches
the recorder; with "fused" or "oracle" the recomputation marches again.
`sample0` is always 0 on the RGB path, as in the JAX package; the
spectral step takes it (the CLI passes k * spp, a fresh sample batch per
step) and, as in the JAX package, has no remat.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import (render_patch,
                                                          render_patch_spp)
from raymarchrenderer_tpu_torch.render.spectral_integrator import (
    SpectralMaterials, render_patch_spp_spectral)
from raymarchrenderer_tpu_torch.scene.graph import (Scene, param_leaves,
                                                    params_replace)


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """How to lay the render over devices: chips along the pixel rows
    (`tile`) and along the samples (`spp`)."""
    tile: int = 1
    spp: int = 1

    def total(self) -> int:
        return self.tile * self.spp


def _one_device(shard: ShardConfig) -> None:
    if shard.total() != 1:
        raise NotImplementedError(
            f"{shard}: only the one-device layout (tile = spp = 1) is ported;"
            " sharding over devices is a later slice (ROADMAP Queue 1 "
            "item 7)")


def render_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                   spp: int, direct_light: bool = False,
                   impl: str = "oracle", shard: ShardConfig = ShardConfig()):
    """The (H, W, 3) mean image of samples 0 .. spp - 1 on the corners'
    device: the sum over samples divided once by spp.  `impl="fused"` is
    one launch of the RGB megakernel (`render_fused_patch`, the plain
    version on the CPU); "oracle" sums `render_patch` sample by sample."""
    _one_device(shard)
    shape = (cfg.height, cfg.width)
    with torch.no_grad():
        if impl == "fused":
            from raymarchrenderer_tpu_torch.kernels.march import (
                render_fused_patch)
            acc = render_fused_patch(scene, params, cfg, corners, (0, 0),
                                     shape, 0, n_samples=spp,
                                     direct_light=direct_light,
                                     normalize=False)
        elif impl == "oracle":
            acc = torch.zeros((*shape, 3), dtype=torch.float32,
                              device=corners.device)
            for s in range(spp):
                acc = acc + render_patch(scene, params, cfg, corners, (0, 0),
                                         shape, s, direct_light).stack(-1)
        else:
            raise ValueError(f"impl must be 'fused' or 'oracle', not {impl!r}")
    return acc / float(spp)


def _render_sum(scene, params, cfg, corners, spp, direct_light, march_impl,
                remat, recorded=None):
    """The differentiable (H, W, 3) sum over samples 0 .. spp - 1."""
    shape = (cfg.height, cfg.width)
    if march_impl == "recorded" and recorded is None:
        # the recorder runs once, outside the checkpointed replay
        from raymarchrenderer_tpu_torch.kernels.record import (
            trace_record_fused)
        recorded = trace_record_fused(scene, params, cfg, corners, (0, 0),
                                      shape, 0, n_samples=spp,
                                      direct_light=direct_light)

    def trace(params, recorded):
        return render_patch_spp(scene, params, cfg, corners, (0, 0), shape,
                                0, spp, direct_light, differentiable=True,
                                march_impl=march_impl,
                                recorded=recorded).stack(-1)

    if remat and torch.is_grad_enabled():
        return checkpoint(trace, params, recorded, use_reentrant=False,
                          preserve_rng_state=False)
    return trace(params, recorded)


def _loss(acc, target, spp: int, cfg: RenderConfig):
    img = acc / float(spp)
    return torch.sum((img - target) ** 2) / float(cfg.height * cfg.width * 3)


def _check_target(target, cfg: RenderConfig, corners):
    if tuple(target.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(f"target is {tuple(target.shape)}, the render is "
                         f"({cfg.height}, {cfg.width}, 3)")
    if target.device != corners.device:
        raise ValueError(f"target on {target.device}, corners on "
                         f"{corners.device}")


def train_loss_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                       target, spp: int, direct_light: bool = False,
                       march_impl: str = "oracle",
                       shard: ShardConfig = ShardConfig(), recorded=None):
    """The forward half of `train_step_sharded` alone: the same
    differentiable-mode render and loss, with no graph kept (`recorded`
    as for `train_grads_sharded`)."""
    _one_device(shard)
    _check_target(target, cfg, corners)
    with torch.no_grad():
        acc = _render_sum(scene, params, cfg, corners, spp, direct_light,
                          march_impl, False, recorded)
        return _loss(acc, target, spp, cfg)


def train_grads_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                        target, spp: int, direct_light: bool = False,
                        march_impl: str = "oracle", remat: bool = True,
                        shard: ShardConfig = ShardConfig(), recorded=None):
    """(loss, grads): the loss of `train_step_sharded` and its gradient
    with respect to every leaf of `params`, as a tree of the same
    structure (zeros where the loss does not reach a leaf).  With
    `march_impl="recorded"`, `recorded` replays banks recorded already
    (`kernels.record`) instead of recording them."""
    _one_device(shard)
    _check_target(target, cfg, corners)
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in param_leaves(params)]
    fit = params_replace(params, leaves)
    with torch.enable_grad():
        acc = _render_sum(scene, fit, cfg, corners, spp, direct_light,
                          march_impl, remat, recorded)
        loss = _loss(acc, target, spp, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for g, leaf in zip(grads, leaves)]
    return loss.detach(), params_replace(params, grads)


def sgd(params, grads, lr: float):
    """p - lr * g on every leaf."""
    return params_replace(params, [
        p.detach() - lr * g for p, g in zip(param_leaves(params),
                                            param_leaves(grads))])


def train_step_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                       target, spp: int, lr: float = 1e-2,
                       direct_light: bool = False,
                       march_impl: str = "oracle", remat: bool = True,
                       shard: ShardConfig = ShardConfig()):
    """One inverse-rendering SGD step: returns (loss, updated params).

    The render is all `spp` samples of the frame in one sample-folded
    trace (`render_patch_spp`), each march by `march_impl`: "recorded"
    (one launch of the recording megakernel, then the replay), "fused"
    (one `march_fused` launch per bounce and per shadow ray) or "oracle"
    (the plain march)."""
    loss, grads = train_grads_sharded(scene, params, cfg, corners, target,
                                      spp, direct_light, march_impl, remat,
                                      shard)
    return loss, sgd(params, grads, lr)


def render_sharded_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                            corners, spp: int,
                            shard: ShardConfig = ShardConfig()):
    """The (H, W, 3) mean spectral image of samples 0 .. spp - 1: one
    `render_fused_spectral` launch of all `spp` samples (the spectral
    megakernel on the card, its plain version on the CPU), the sum divided
    once by spp."""
    from raymarchrenderer_tpu_torch.kernels.march import (
        render_fused_spectral)
    _one_device(shard)
    with torch.no_grad():
        acc = render_fused_spectral(scene, params, mats, cfg, corners, 0,
                                    n_samples=spp, normalize=False)
    return acc / float(spp)


def _clamp_bands(minw, maxw, power):
    """Band rows inside [380, 830] nm with max >= min + 5, power >= 1e-4.
    Written as `jnp.clip` is, minimum(maximum(x, lo), hi), so a row at a
    bound splits its gradient half and half as in the JAX package
    (`torch.clamp` would pass it all to x)."""
    def lo_hi(x, lo, hi):
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
        if hi is None:
            return x
        return torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                                device=x.device))

    minw = lo_hi(minw, 380.0, 825.0)
    maxw = lo_hi(maxw, minw + 5.0, 830.0)
    return minw, maxw, lo_hi(power, 1e-4, None)


def _spectral_render_sum(scene, params, bands, kind, cfg, corners, spp,
                         march_impl, soft_edge, sample0, recorded):
    """The differentiable (H, W, 3) sum over samples sample0 .. sample0 +
    spp - 1 with the band rows `bands` clamped."""
    mats = SpectralMaterials(*_clamp_bands(*bands), kind)
    return render_patch_spp_spectral(
        scene, params, mats, cfg, corners, (0, 0), (cfg.height, cfg.width),
        sample0, spp, differentiable=True, march_impl=march_impl,
        soft_edge=soft_edge, recorded=recorded).stack(-1)


def train_loss_spectral_sharded(scene: Scene, params, mats, cfg, corners,
                                target, spp: int,
                                march_impl: str = "oracle",
                                soft_edge: float = 8.0, sample0=0,
                                shard: ShardConfig = ShardConfig(),
                                recorded=None):
    """The forward half of `train_step_spectral_sharded` alone: the same
    render and loss, with no graph kept (`recorded` as for
    `train_grads_spectral_sharded`)."""
    _one_device(shard)
    _check_target(target, cfg, corners)
    with torch.no_grad():
        acc = _spectral_render_sum(scene, params, tuple(mats[:3]), mats.kind,
                                   cfg, corners, spp, march_impl, soft_edge,
                                   sample0, recorded)
        return _loss(acc, target, spp, cfg)


def train_grads_spectral_sharded(scene: Scene, params, mats, cfg, corners,
                                 target, spp: int,
                                 march_impl: str = "oracle",
                                 soft_edge: float = 8.0, sample0=0,
                                 shard: ShardConfig = ShardConfig(),
                                 recorded=None):
    """(loss, param grads, band grads): the loss of
    `train_step_spectral_sharded` and its gradient with respect to every
    leaf of `params` (a tree of the same structure, zeros where the loss
    does not reach a leaf) and to the band rows (min_wave, max_wave,
    power).  With `march_impl="recorded"`, `recorded` replays banks of
    `kernels.record.trace_record_fused_spectral` recorded already."""
    _one_device(shard)
    _check_target(target, cfg, corners)
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in param_leaves(params)]
    bands = [b.detach().requires_grad_(True) for b in mats[:3]]
    fit = params_replace(params, leaves)
    with torch.enable_grad():
        acc = _spectral_render_sum(scene, fit, bands, mats.kind, cfg, corners,
                                   spp, march_impl, soft_edge, sample0,
                                   recorded)
        loss = _loss(acc, target, spp, cfg)
        grads = torch.autograd.grad(loss, leaves + bands, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves + bands)]
    return (loss.detach(), params_replace(params, grads[:len(leaves)]),
            tuple(grads[len(leaves):]))


def spectral_update(params, mats, grads, band_grads, lr: float,
                    lr_bands_nm: float = 3.0):
    """(p - lr * g on every scene leaf, the band rows stepped by sign:
    lr_bands_nm nm for min and max, 0.01 * lr_bands_nm for power, then
    clamped).  A zero gradient moves nothing."""
    step = float(np.float32(lr_bands_nm))
    step_p = float(np.float32(0.01) * np.float32(lr_bands_nm))
    g_min, g_max, g_pow = band_grads
    bands = _clamp_bands(mats.min_wave.detach() - step * torch.sign(g_min),
                         mats.max_wave.detach() - step * torch.sign(g_max),
                         mats.power.detach() - step_p * torch.sign(g_pow))
    return sgd(params, grads, lr), SpectralMaterials(*bands, mats.kind)


def train_step_spectral_sharded(scene: Scene, params, mats, cfg, corners,
                                target, spp: int, lr: float = 1e-2,
                                lr_bands_nm: float = 3.0,
                                march_impl: str = "oracle",
                                soft_edge: float = 8.0, sample0=0,
                                shard: ShardConfig = ShardConfig()):
    """One spectral inverse-rendering step: returns (loss, updated params,
    updated `SpectralMaterials`).

    The render is all `spp` samples from `sample0` in one sample-folded
    trace (`render_patch_spp_spectral(differentiable=True)`: the marches
    carry the implicit-function adjoint, the band filters are soft with
    edge `soft_edge` nm), each march by `march_impl`: "recorded" (one
    launch of the spectral recorder, then the replay), "fused" (one
    `march_fused` launch per bounce) or "oracle".  The fit variables are
    the scene parameters (SGD) and the band rows (a sign step,
    `spectral_update`); `kind` stays."""
    loss, grads, band_grads = train_grads_spectral_sharded(
        scene, params, mats, cfg, corners, target, spp, march_impl,
        soft_edge, sample0, shard)
    return (loss, *spectral_update(params, mats, grads, band_grads, lr,
                                   lr_bands_nm))
