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
  * `train_loss_sharded` — its forward alone (no graph).

`remat=True` (the default, as in the JAX package) runs the trace under
`torch.utils.checkpoint`: the backward pass recomputes the shading chain
from its inputs instead of keeping every intermediate plane.  With
`march_impl="recorded"` (the train CLI's default) the recorder's banks are
an input of the checkpointed replay, so the backward pass never relaunches
the recorder; with "fused" or "oracle" the recomputation marches again.
`sample0` is always 0 on the RGB path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import (render_patch,
                                                          render_patch_spp)
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
