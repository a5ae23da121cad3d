"""Render and train over a (tile, spp) layout of devices: the JAX
package's `parallel/sharding.py` for the port.

The frame splits along two axes (SURVEY.md §5): pixel rows (`tile`: each
position renders a block of rows_per = ceil(H / tile) rows) and samples
(`spp`: each position renders its slice [si * spp_per, (si + 1) *
spp_per) of the sample indices).  The RNG is keyed on absolute (pixel,
sample) coordinates, so every layout renders the same sample set.  A
`Mesh` (`make_mesh`) names the device of each position: the visible CUDA
devices, or an explicit list in which one device may repeat, so that
several positions run one after the other on it (virtual positions, the
explicit counterpart of XLA's `--xla_force_host_platform_device_count`).

  * `render_sharded` — the mean image of `spp` samples: per position one
    launch of the RGB megakernel (`impl="fused"`, `render_fused_patch`;
    the plain version on the CPU; an env image through its deferred
    route) or the oracle (`render_patch` sample by sample), each with
    `normalize=False`.  Renders pad: a height the tile axis does not
    divide leaves the last tile fewer rows (pixels are independent, so
    the kept rows are the bytes of the JAX package's pad-and-crop), and
    the spp remainder is one extra sample n_spp * spp_per + si on the
    positions si < spp % n_spp;
  * `render_sharded_spectral` — the same layout over
    `render_fused_spectral(origin_xy=..., patch_shape=...)`;
  * `train_step_sharded` — one inverse-rendering SGD step: per position
    the differentiable sum of its patch and sample slice
    (`render_patch_spp(differentiable=True)`, under remat), the pixel L2
    loss sum((acc / spp - target)^2) / (H * W * 3) of the merged frame,
    gradients to every parameter leaf by autograd (a leaf the loss does
    not reach gets zeros), and p - lr * g on every leaf;
    `train_grads_sharded` is its loss and gradients, `train_loss_sharded`
    its forward alone.  Train steps do not pad: a height or spp the
    layout does not divide raises, as in the JAX package;
  * `train_step_spectral_sharded` — one spectral inverse-rendering step
    (`train --spectral`): the soft-band differentiable render
    (`render_patch_spp_spectral(differentiable=True)`), the same loss,
    SGD on the scene parameters and a sign step on the band rows (min and
    max wavelength, power), clamped to the visible range by
    `_clamp_bands`; split as the RGB step is into
    `train_grads_spectral_sharded`, `train_loss_spectral_sharded` and
    `spectral_update`.

A render takes `sample0` (default 0): position (ti, si) renders samples
sample0 + si * spp_per .., and the remainder's extra sample is shifted by
sample0 too, so frame k of a progressive render at `sample0 = k * spp`
continues the sequence.  It runs in three phases (`_render_merged`):
every card's inputs placed, then every position launched on its card's
stream with no host wait between launches, so the cards render at once,
then the merge, in the profiler spans `rmr.position` and `rmr.merge`.
The merge sums the partial sums of one tile in si order, joins the tiles
in row order and divides once by spp.  With one sample slice per tile it
is byte-equal to one launch over the frame; with an spp axis the sum is
re-associated.  A train step's gradient is that of the merged loss: the
positions' sums meet in one autograd graph (each position's copy of a
leaf is a differentiable `.to(device)`), so the gradient is the same for
every layout.  (The JAX package's sharded step psums gradients that are
already global, so its update is tile * spp times this one; ROADMAP
Queue 3.)  With `march_impl="recorded"` (the train CLI's default) each
position's recorder launch covers only its own patch and slice.

Across processes (`multihost.init`) each rank runs the positions it
owns; the merge is one all-reduce of the ranks' partial frames, so every
rank returns the merged frame, and a train step backpropagates the merged
loss's cotangent through its own sums, then all-reduces the gradients
once.

`remat=True` (the default, as in the JAX package) runs each position's
trace under `torch.utils.checkpoint`: the backward pass recomputes the
shading chain from its inputs instead of keeping every intermediate plane.
With "recorded" the recorder's banks are an input of the checkpointed
replay, so the backward pass never relaunches the recorder; with "fused"
or "oracle" the recomputation marches again.  `sample0` is always 0 on
the RGB path, as in the JAX package; the spectral step takes it (the CLI
passes k * spp, a fresh sample batch per step) and has no remat.

A train step's phases run in profiler spans (`utils.profiling.span`):
`rmr.forward` (the positions' sums and the loss, the recorder inside it
in `rmr.record`), `rmr.backward` (the gradients and their all-reduce) and
`rmr.update` (`sgd`, `spectral_update`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raymarchrenderer_tpu_torch.parallel import multihost
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import (render_patch,
                                                          render_patch_spp)
from raymarchrenderer_tpu_torch.render.spectral_integrator import (
    SpectralMaterials, render_patch_spp_spectral)
from raymarchrenderer_tpu_torch.scene.graph import (Scene, param_leaves,
                                                    params_replace)
from raymarchrenderer_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """How to lay the render over devices: positions along the pixel rows
    (`tile`) and along the samples (`spp`)."""
    tile: int = 1
    spp: int = 1

    def total(self) -> int:
        return self.tile * self.spp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, spp) grid of positions: `devices[ti][si]` renders position
    (ti, si), and `ranks[ti][si]` is the process that owns it (0 in one
    process); `rank` is this process's."""
    devices: tuple
    ranks: tuple
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {"tile": len(self.devices), "spp": len(self.devices[0])}

    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def local_positions(self) -> list:
        """[(ti, si, device)] of the positions this process owns, in
        position order."""
        return [(ti, si, dev) for ti, row in enumerate(self.devices)
                for si, dev in enumerate(row)
                if self.ranks[ti][si] == self.rank]


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shard: ShardConfig, devices=None) -> Mesh:
    """The (shard.tile, shard.spp) layout over the first shard.total()
    devices, rank-major across processes (each rank contributes its
    `devices`, default the visible CUDA devices).  A device may repeat:
    its positions run one after the other.  Raises ValueError("need N
    devices, have M") when there are too few."""
    if shard.tile < 1 or shard.spp < 1:
        raise ValueError(f"{shard}: tile and spp must be >= 1")
    local = (_visible_devices() if devices is None
             else [torch.device(d) for d in devices])
    names = multihost.all_gather_object([str(d) for d in local])
    flat = [(torch.device(d), r) for r, ds in enumerate(names) for d in ds]
    n = shard.total()
    if len(flat) < n:
        raise ValueError(f"need {n} devices, have {len(flat)}")
    rows = [flat[t * shard.spp:(t + 1) * shard.spp]
            for t in range(shard.tile)]
    return Mesh(devices=tuple(tuple(d for d, _ in row) for row in rows),
                ranks=tuple(tuple(r for _, r in row) for row in rows),
                rank=multihost.process_index())


def auto_shard(n_devices: Optional[int] = None) -> ShardConfig:
    """Tiles first, a power of two up to 8, and the rest on the spp axis
    (the JAX package's rule); `n_devices` defaults to the visible CUDA
    devices of every process."""
    n = (sum(multihost.all_gather_object(len(_visible_devices())))
         if n_devices is None else int(n_devices))
    if n < 1:
        raise ValueError(f"need 1 device, have {n}")
    tile = 1
    while tile * 2 <= n and tile < 8:
        tile *= 2
    return ShardConfig(tile=tile, spp=n // tile)


def _one_position(mesh: Optional[Mesh], corners) -> Mesh:
    """`mesh`, or the one-position layout on the corners' device."""
    if mesh is not None:
        return mesh
    return Mesh(devices=((corners.device,),), ranks=((0,),))


def _tree_to(tree, device):
    """`tree` with every leaf on `device` (differentiable copies; the tree
    itself where every leaf is there already)."""
    leaves = param_leaves(tree)
    if all(leaf.device == device for leaf in leaves):
        return tree
    return params_replace(tree, [leaf.to(device) for leaf in leaves])


def render_replicated_params(scene: Scene, params, mesh: Mesh) -> dict:
    """{device: params on it} for the devices of this process's positions
    (the uniform upload, `Graphics.cpp:316-348`): each leaf copied once to
    each device, and `params` itself where a device holds it already."""
    out = {}
    for _, _, dev in mesh.local_positions():
        if dev not in out:
            out[dev] = _tree_to(params, dev)
    return out


def _tile_rows(cfg: RenderConfig, rows_per: int, ti: int) -> int:
    """The rows of tile ti inside the frame (0 past its bottom)."""
    return max(0, min(rows_per, cfg.height - ti * rows_per))


def _merge(parts: dict, mesh: Mesh, cfg: RenderConfig, rows_per: int,
           device):
    """This process's (H, W, 3) partial frame: each tile's parts summed
    in si order, the tiles joined in row order; a tile with no part here
    is zeros (another rank renders it)."""
    tiles = []
    for ti in range(mesh.shape["tile"]):
        ph = _tile_rows(cfg, rows_per, ti)
        if ph == 0:
            break
        tile = None
        for si in range(mesh.shape["spp"]):
            part = parts.get((ti, si))
            if part is not None:
                tile = part if tile is None else tile + part
        if tile is None:
            tile = torch.zeros((ph, cfg.width, 3), dtype=torch.float32,
                               device=device)
        tiles.append(tile)
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, 0)


def _render_merged(mesh: Mesh, cfg: RenderConfig, corners, spp: int,
                   sample0: int, place, launch):
    """The (H, W, 3) mean over samples sample0 .. sample0 + spp - 1 on the
    corners' device, merged across processes, in three phases:

      (a) `place(device, corners there)` puts each device's inputs there
          (once a device), before any launch, so that no position's
          inputs queue behind a launch on another card;
      (b) `launch(inputs, origin_xy, patch_shape, sample0, n)` renders
          each position's raw sum on its card's current stream: no host
          wait and no copy between cards until every position is
          launched;
      (c) the merge on the corners' device: the parts summed in si order,
          the tiles joined in row order, one divide by spp.

    Each position's placement and, again, its launch run in the profiler
    span `rmr.position`; the merge, from its first copy between devices
    to the divide, in `rmr.merge`."""
    if spp < 1:
        raise ValueError("spp must be >= 1")
    rows_per = -(-cfg.height // mesh.shape["tile"])
    n_spp = mesh.shape["spp"]
    spp_per, spp_rem = divmod(int(spp), n_spp)
    s0 = int(sample0)
    positions = [(ti, si, dev) for ti, si, dev in mesh.local_positions()
                 if _tile_rows(cfg, rows_per, ti)]
    inputs, parts = {}, {}
    with torch.no_grad():
        for _, _, dev in positions:
            with span("rmr.position"):
                if dev not in inputs:
                    inputs[dev] = place(dev, corners.to(dev))
        for ti, si, dev in positions:
            with span("rmr.position"):
                origin = (0, ti * rows_per)
                patch = (_tile_rows(cfg, rows_per, ti), cfg.width)
                acc = None
                if spp_per:
                    acc = launch(inputs[dev], origin, patch,
                                 s0 + si * spp_per, spp_per)
                if si < spp_rem:
                    extra = launch(inputs[dev], origin, patch,
                                   s0 + n_spp * spp_per + si, 1)
                    acc = extra if acc is None else acc + extra
                if acc is not None:
                    parts[(ti, si)] = acc
        with span("rmr.merge"):
            parts = {k: v.to(corners.device) for k, v in parts.items()}
            total = _merge(parts, mesh, cfg, rows_per, corners.device)
            if multihost.process_count() > 1:
                total = multihost.all_reduce(total)
            return total / float(spp)


def render_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                   spp: int, direct_light: bool = False,
                   impl: str = "oracle", mesh: Optional[Mesh] = None,
                   sample0: int = 0):
    """The (H, W, 3) mean image of samples sample0 .. sample0 + spp - 1 on
    the corners' device, over `mesh` (default: one position on the
    corners' device).  `impl="fused"` is one `render_fused_patch` launch
    per position (the RGB megakernel on the card, its plain version on the
    CPU); "oracle" sums `render_patch` sample by sample."""
    from raymarchrenderer_tpu_torch.kernels.march import render_fused_patch
    if impl not in ("fused", "oracle"):
        raise ValueError(f"impl must be 'fused' or 'oracle', not {impl!r}")
    mesh = _one_position(mesh, corners)

    def place(dev, c):
        return _tree_to(params, dev), c

    def launch(inputs, origin, patch, s0, n):
        p, c = inputs
        if impl == "fused":
            return render_fused_patch(scene, p, cfg, c, origin, patch, s0,
                                      n_samples=n, direct_light=direct_light,
                                      normalize=False)
        acc = torch.zeros((*patch, 3), dtype=torch.float32, device=c.device)
        for s in range(s0, s0 + n):
            acc = acc + render_patch(scene, p, cfg, c, origin, patch, s,
                                     direct_light).stack(-1)
        return acc

    return _render_merged(mesh, cfg, corners, spp, sample0, place, launch)


def render_sharded_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                            corners, spp: int, mesh: Optional[Mesh] = None,
                            sample0: int = 0):
    """The (H, W, 3) mean spectral image of samples sample0 .. sample0 +
    spp - 1 over `mesh`: one `render_fused_spectral` launch per position
    (the spectral megakernel on the card, its plain version on the
    CPU)."""
    from raymarchrenderer_tpu_torch.kernels.march import (
        render_fused_spectral)
    mesh = _one_position(mesh, corners)

    def place(dev, c):
        return _tree_to(params, dev), _mats_to(mats, dev), c

    def launch(inputs, origin, patch, s0, n):
        p, m, c = inputs
        return render_fused_spectral(scene, p, m, cfg, c, s0, n_samples=n,
                                     origin_xy=origin, patch_shape=patch,
                                     normalize=False)

    return _render_merged(mesh, cfg, corners, spp, sample0, place, launch)


def _mats_to(mats, device) -> SpectralMaterials:
    return SpectralMaterials(*(_tree_to(list(mats[:3]), device)),
                             mats.kind.to(device))


def gather_image(img) -> np.ndarray:
    """The image on the host (the `glReadPixels` analogue,
    `Graphics.cpp:759`); across processes use
    `multihost.gather_to_host0`."""
    return np.asarray(img.detach().cpu() if torch.is_tensor(img) else img)


# ---- train steps -----------------------------------------------------------

def _train_layout(mesh: Mesh, cfg: RenderConfig, spp: int):
    """(rows_per, spp_per) of a train step; raises where the layout does
    not divide the frame and the samples (the JAX package's limit)."""
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    if cfg.height % n_tile or spp % n_spp:
        raise ValueError("height/spp must divide the mesh axes")
    return cfg.height // n_tile, spp // n_spp


def _train_partial(mesh: Mesh, cfg: RenderConfig, corners, spp: int,
                   trees, recorded, local_sum):
    """This process's (H, W, 3) partial frame of a train step:
    `local_sum(*trees on the position's device, corners there, origin_xy,
    patch_shape, sample offset, n, recorded)` per position, merged."""
    rows_per, spp_per = _train_layout(mesh, cfg, spp)
    if recorded is not None and mesh.size() != 1:
        raise ValueError("recorded banks replay the one-position layout; "
                         "each position of a larger one records its own")
    parts = {}
    for ti, si, dev in mesh.local_positions():
        local = local_sum(*(_tree_to(t, dev) for t in trees),
                          corners.to(dev), (0, ti * rows_per),
                          (rows_per, cfg.width), si * spp_per, spp_per,
                          recorded)
        parts[(ti, si)] = local.to(corners.device)
    return _merge(parts, mesh, cfg, rows_per, corners.device)


def _merged_loss(partial, target, spp: int, cfg: RenderConfig):
    """The loss of the merged frame, without a graph."""
    if multihost.process_count() > 1:
        partial = multihost.all_reduce(partial)
    return _loss(partial, target, spp, cfg)


def _loss_and_grads(mesh: Mesh, cfg: RenderConfig, corners, spp: int,
                    trees, recorded, local_sum, target, xs):
    """(loss, gradients to `xs`, zeros where the loss does not reach one)
    of the merged frame of `_train_partial(mesh, cfg, corners, spp, trees,
    recorded, local_sum)`: the forward and the loss in the profiler span
    `rmr.forward`, the gradients in `rmr.backward`.  Across processes:
    the merged frame's cotangent backpropagated through this rank's sums,
    then one all-reduce of the gradients."""
    with span("rmr.forward"):
        partial = _train_partial(mesh, cfg, corners, spp, trees, recorded,
                                 local_sum)
        total = partial
        if multihost.process_count() > 1:
            total = multihost.all_reduce(partial).requires_grad_(True)
        loss = _loss(total, target, spp, cfg)
    with span("rmr.backward"):
        if multihost.process_count() == 1:
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
            return loss.detach(), [torch.zeros_like(x) if g is None else g
                                   for g, x in zip(grads, xs)]
        (cot,) = torch.autograd.grad(loss, total)
        grads = (torch.autograd.grad(partial, xs, cot, allow_unused=True)
                 if partial.requires_grad else [None] * len(xs))
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, xs)]
        flat = multihost.all_reduce(
            torch.cat([g.reshape(-1) for g in grads]))
        sizes = [g.numel() for g in grads]
        return loss.detach(), [f.reshape(g.shape).to(g.dtype) for f, g in
                               zip(torch.split(flat, sizes), grads)]


def _render_sum(scene, params, cfg, corners, origin_xy, patch_shape,
                sample0, n, direct_light, march_impl, remat, recorded=None):
    """The differentiable (ph, pw, 3) sum over samples sample0 .. sample0
    + n - 1 of one position's patch."""
    if march_impl == "recorded" and recorded is None:
        # the recorder runs once, outside the checkpointed replay
        from raymarchrenderer_tpu_torch.kernels.record import (
            trace_record_fused)
        with span("rmr.record"):
            recorded = trace_record_fused(
                scene, params, cfg, corners, origin_xy, patch_shape, sample0,
                n_samples=n, direct_light=direct_light)

    def trace(params, recorded):
        return render_patch_spp(scene, params, cfg, corners, origin_xy,
                                patch_shape, sample0, n, direct_light,
                                differentiable=True, march_impl=march_impl,
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


def _rgb_local_sum(scene, cfg, direct_light, march_impl, remat):
    def local_sum(params, corners, origin, patch, s0, n, recorded):
        return _render_sum(scene, params, cfg, corners, origin, patch, s0, n,
                           direct_light, march_impl, remat, recorded)
    return local_sum


def train_loss_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                       target, spp: int, direct_light: bool = False,
                       march_impl: str = "oracle",
                       mesh: Optional[Mesh] = None, recorded=None):
    """The forward half of `train_step_sharded` alone: the same
    differentiable-mode render and loss, with no graph kept (`recorded`
    as for `train_grads_sharded`)."""
    _check_target(target, cfg, corners)
    mesh = _one_position(mesh, corners)
    with torch.no_grad():
        partial = _train_partial(
            mesh, cfg, corners, spp, (params,), recorded,
            _rgb_local_sum(scene, cfg, direct_light, march_impl, False))
        return _merged_loss(partial, target, spp, cfg)


def train_grads_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                        target, spp: int, direct_light: bool = False,
                        march_impl: str = "oracle", remat: bool = True,
                        mesh: Optional[Mesh] = None, recorded=None):
    """(loss, grads): the loss of `train_step_sharded` and its gradient
    with respect to every leaf of `params`, as a tree of the same
    structure (zeros where the loss does not reach a leaf), on the
    corners' device.  With `march_impl="recorded"` on the one-position
    layout, `recorded` replays banks recorded already (`kernels.record`)
    instead of recording them."""
    _check_target(target, cfg, corners)
    mesh = _one_position(mesh, corners)
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in param_leaves(params)]
    fit = params_replace(params, leaves)
    with torch.enable_grad():
        loss, grads = _loss_and_grads(
            mesh, cfg, corners, spp, (fit,), recorded,
            _rgb_local_sum(scene, cfg, direct_light, march_impl, remat),
            target, leaves)
    return loss, params_replace(params, grads)


def _sgd(params, grads, lr: float):
    return params_replace(params, [
        p.detach() - lr * g for p, g in zip(param_leaves(params),
                                            param_leaves(grads))])


def sgd(params, grads, lr: float):
    """p - lr * g on every leaf (in the profiler span `rmr.update`)."""
    with span("rmr.update"):
        return _sgd(params, grads, lr)


def train_step_sharded(scene: Scene, params, cfg: RenderConfig, corners,
                       target, spp: int, lr: float = 1e-2,
                       direct_light: bool = False,
                       march_impl: str = "oracle", remat: bool = True,
                       mesh: Optional[Mesh] = None):
    """One inverse-rendering SGD step: returns (loss, updated params).

    Each position renders its rows and samples in one sample-folded trace
    (`render_patch_spp`), each march by `march_impl`: "recorded" (one
    launch of the recording megakernel per position, then the replay),
    "fused" (one `march_fused` launch per bounce and per shadow ray) or
    "oracle" (the plain march)."""
    loss, grads = train_grads_sharded(scene, params, cfg, corners, target,
                                      spp, direct_light, march_impl, remat,
                                      mesh)
    return loss, sgd(params, grads, lr)


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


def _spectral_local_sum(scene, kind, cfg, march_impl, soft_edge, sample0):
    """A position's differentiable sum over samples sample0 + s0 ..
    sample0 + s0 + n - 1, with the band rows clamped."""
    def local_sum(params, bands, corners, origin, patch, s0, n, recorded):
        mats = SpectralMaterials(*_clamp_bands(*bands),
                                 kind.to(corners.device))
        return render_patch_spp_spectral(
            scene, params, mats, cfg, corners, origin, patch,
            int(sample0) + s0, n, differentiable=True,
            march_impl=march_impl, soft_edge=soft_edge,
            recorded=recorded).stack(-1)
    return local_sum


def train_loss_spectral_sharded(scene: Scene, params, mats, cfg, corners,
                                target, spp: int,
                                march_impl: str = "oracle",
                                soft_edge: float = 8.0, sample0=0,
                                mesh: Optional[Mesh] = None, recorded=None):
    """The forward half of `train_step_spectral_sharded` alone: the same
    render and loss, with no graph kept (`recorded` as for
    `train_grads_spectral_sharded`)."""
    _check_target(target, cfg, corners)
    mesh = _one_position(mesh, corners)
    with torch.no_grad():
        partial = _train_partial(
            mesh, cfg, corners, spp, (params, list(mats[:3])), recorded,
            _spectral_local_sum(scene, mats.kind, cfg, march_impl, soft_edge,
                                sample0))
        return _merged_loss(partial, target, spp, cfg)


def train_grads_spectral_sharded(scene: Scene, params, mats, cfg, corners,
                                 target, spp: int,
                                 march_impl: str = "oracle",
                                 soft_edge: float = 8.0, sample0=0,
                                 mesh: Optional[Mesh] = None,
                                 recorded=None):
    """(loss, param grads, band grads): the loss of
    `train_step_spectral_sharded` and its gradient with respect to every
    leaf of `params` (a tree of the same structure, zeros where the loss
    does not reach a leaf) and to the band rows (min_wave, max_wave,
    power).  With `march_impl="recorded"` on the one-position layout,
    `recorded` replays banks of `kernels.record.trace_record_fused_spectral`
    recorded already."""
    _check_target(target, cfg, corners)
    mesh = _one_position(mesh, corners)
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in param_leaves(params)]
    bands = [b.detach().requires_grad_(True) for b in mats[:3]]
    fit = params_replace(params, leaves)
    with torch.enable_grad():
        loss, grads = _loss_and_grads(
            mesh, cfg, corners, spp, (fit, bands), recorded,
            _spectral_local_sum(scene, mats.kind, cfg, march_impl, soft_edge,
                                sample0), target, leaves + bands)
    return (loss, params_replace(params, grads[:len(leaves)]),
            tuple(grads[len(leaves):]))


def spectral_update(params, mats, grads, band_grads, lr: float,
                    lr_bands_nm: float = 3.0):
    """(p - lr * g on every scene leaf, the band rows stepped by sign:
    lr_bands_nm nm for min and max, 0.01 * lr_bands_nm for power, then
    clamped; in the profiler span `rmr.update`).  A zero gradient moves
    nothing."""
    step = float(np.float32(lr_bands_nm))
    step_p = float(np.float32(0.01) * np.float32(lr_bands_nm))
    g_min, g_max, g_pow = band_grads
    with span("rmr.update"):
        bands = _clamp_bands(
            mats.min_wave.detach() - step * torch.sign(g_min),
            mats.max_wave.detach() - step * torch.sign(g_max),
            mats.power.detach() - step_p * torch.sign(g_pow))
        return _sgd(params, grads, lr), SpectralMaterials(*bands, mats.kind)


def train_step_spectral_sharded(scene: Scene, params, mats, cfg, corners,
                                target, spp: int, lr: float = 1e-2,
                                lr_bands_nm: float = 3.0,
                                march_impl: str = "oracle",
                                soft_edge: float = 8.0, sample0=0,
                                mesh: Optional[Mesh] = None):
    """One spectral inverse-rendering step: returns (loss, updated params,
    updated `SpectralMaterials`).

    Each position renders its rows and samples (from `sample0`) in one
    sample-folded trace (`render_patch_spp_spectral(differentiable=True)`:
    the marches carry the implicit-function adjoint, the band filters are
    soft with edge `soft_edge` nm), each march by `march_impl`:
    "recorded" (one launch of the spectral recorder per position, then the
    replay), "fused" (one `march_fused` launch per bounce) or "oracle".
    The fit variables are the scene parameters (SGD) and the band rows (a
    sign step, `spectral_update`); `kind` stays."""
    loss, grads, band_grads = train_grads_spectral_sharded(
        scene, params, mats, cfg, corners, target, spp, march_impl,
        soft_edge, sample0, mesh)
    return (loss, *spectral_update(params, mats, grads, band_grads, lr,
                                   lr_bands_nm))
