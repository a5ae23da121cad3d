"""A closed loop of spectral inverse-rendering steps, as `train
--spectral` runs them on one card: step k is
`parallel.sharding.train_grads_spectral_sharded` on the one-position
layout (the recorder `rmr_record_spectral`, then the differentiable
replay and its backward) over samples k * spp .. k * spp + spp - 1,
then `spectral_update`, and reading the loss, which waits for the card.
The configuration's `train` section gives the job's settings (samples,
bounces, relaxation, learning rates); the target image is made on the
card from the seed.

Set-up builds the one train state and drives it through the traffic's
`first_steps` steps by the window's own step; the window goes on from
there with that same state.  `train_step_ms`: the window's wall time
over the steps completed in it.

The check, by the rules `PERF.md` states, holds two stretches of the
state's run to the reference:

  * the first steps, which the reference follows from the same start
    (its own parse of the scene) and target: `loss_gap`, the largest
    relative gap of a step's loss, and `change_gap`, the worst leaf's
    gap between the norms of its change over those steps;
  * the window's last step, timed, which the reference takes from the
    program's state before it (the leaves held when that step began)
    with the same samples: `last_loss_gap` and `last_change_gap`, the
    same numbers of that one step.

A change gap is measured against the reference's norm of that leaf's
change or of the median leaf's, whichever is larger, over the leaves
whose gradient in the reference is not nought (exactly zero, or under a
thousandth of the median of the other leaves') at the stretch's first
step.
"""
from __future__ import annotations

import contextlib
import time

import torch

from rmbench.check import bf16_control, load_limits
from rmbench.program import Program, sync


def _target(run, cfg):
    """An (H, W, 3) float32 target on the run's device: an 8 x 8 grid of
    uniform values in [0, 0.5) per channel from the seed, bilinearly
    upsampled to the frame."""
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed % (1 << 63))
    low = torch.rand((1, 3, 8, 8), generator=gen, device=run.device) * 0.5
    up = torch.nn.functional.interpolate(
        low, size=(cfg.height, cfg.width), mode="bilinear",
        align_corners=False)
    return up[0].permute(1, 2, 0).contiguous()


def _leaves(params, mats):
    from raymarchrenderer_tpu_torch.scene.graph import param_leaves
    return [x.detach().clone() for x in param_leaves(params)] + [
        m.detach().clone() for m in mats[:3]]


def setup(run) -> None:
    from raymarchrenderer_tpu_torch.kernels.march import RECORD_SPECTRAL
    from raymarchrenderer_tpu_torch.kernels.march import prepare
    job = run.config["train"]
    prog = Program(run, job["render"])
    prepare(run.device, RECORD_SPECTRAL)
    run.prog = prog
    run.lr = float(job["lr"])
    run.lr_bands_nm = float(job["lr_bands_nm"])
    run.spp = prog.cfg.spp
    run.target = _target(run, prog.cfg)
    run.params, run.mats = prog.params, prog.mats
    run.k = 0
    run.start = _leaves(run.params, run.mats)
    run.losses = []
    for _ in range(int(run.traffic["first_steps"])):
        run.losses.append(_step(run))
    run.after = _leaves(run.params, run.mats)


def _step(run) -> float:
    """One train step of the state in `run`; returns the loss, read on
    the host."""
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        spectral_update, train_grads_spectral_sharded)
    prog = run.prog
    loss, grads, band_grads = train_grads_spectral_sharded(
        prog.scene, run.params, run.mats, prog.cfg, prog.corners,
        run.target, run.spp, march_impl="recorded",
        sample0=run.k * run.spp)
    run.params, run.mats = spectral_update(run.params, run.mats, grads,
                                           band_grads, run.lr,
                                           run.lr_bands_nm)
    run.k += 1
    return float(loss)


def warm(run) -> None:
    sync(run.device)


def window(run, seconds: float) -> None:
    n = 0
    t0 = time.perf_counter()
    while True:
        before = (run.params, run.mats, run.k)
        loss = _step(run)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.attempted = n
    run.e2e["train_step_ms"] = run.window_s / n * 1e3
    # the window's last step: the state it began from (update builds new
    # tensors, so holding them copies nothing), its index, its loss and
    # the state it left
    run.last = (_leaves(*before[:2]), before[2], loss,
                _leaves(run.params, run.mats))


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def reference_steps(run, n_steps: int, k0: int = 0, leaves=None,
                    control: bool = False):
    """(losses, gradients of the first step, leaves after `n_steps`) of
    the reference's steps k0 .. k0 + n_steps - 1 over the same target and
    samples, from its own start or, given `leaves`, from those values of
    the scene leaves and band rows."""
    from rmbench.reference import bands, graph, train
    cfg = run.prog.ref_cfg
    scene = graph.loads_scene(run.scene_text())
    params = scene.init_params(run.device)
    mats = bands.band_table(scene, run.device)
    if leaves is not None:
        n = len(graph.param_leaves(params))
        params = graph.params_replace(params,
                                      [x.clone() for x in leaves[:n]])
        mats = mats._replace(min_wave=leaves[n].clone(),
                             max_wave=leaves[n + 1].clone(),
                             power=leaves[n + 2].clone())
    cam = run.prog.corners
    losses, first = [], None
    for k in range(k0, k0 + n_steps):
        with (bf16_control() if control else contextlib.nullcontext()):
            loss, g, bg = train.loss_and_grads(scene, params, mats, cfg,
                                               cam, run.target, run.spp,
                                               k * run.spp)
            params, mats = train.update(params, mats, g, bg, run.lr,
                                        run.lr_bands_nm)
        losses.append(float(loss))
        if first is None:
            first = [x.detach() for x in g + bg]
    return losses, first, [x.detach() for x in
                           graph.param_leaves(params) + list(mats[:3])]


def _gaps(losses, ref_losses, start, after, ref_after, grads):
    """(loss gap, change gap) of a stretch of steps from `start`."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g_norms = [_norm(g) for g in grads]
    live = sorted(x for x in g_norms if x > 0)
    median_g = live[len(live) // 2] if live else 0.0
    keep = [i for i, x in enumerate(g_norms)
            if x > 0 and x >= 1e-3 * median_g]
    ref_change = [_norm(ref_after[i] - start[i]) for i in keep]
    got_change = [_norm(after[i] - start[i]) for i in keep]
    median_c = sorted(ref_change)[len(ref_change) // 2] if keep else 0.0
    change_gap = max((abs(a - b) / max(b, median_c, 1e-30)
                      for a, b in zip(got_change, ref_change)), default=0.0)
    return loss_gap, change_gap


def check(run, control: bool = False) -> None:
    """Hold the first steps and the window's last step to the
    reference's; `control` puts the reference at bfloat16 in the
    program's place."""
    before, k_last, loss_last, after_last = run.last
    stretches = (
        ("", 0, None, run.start, run.losses, run.after),
        ("last_", k_last, before, before, [loss_last], after_last))
    run.params = run.mats = run.last = None
    run.readings, failed = {}, 0
    limits = load_limits(run.workload, run.spec.root)
    for tag, k0, leaves, start, losses, after in stretches:
        n = len(losses)
        ref_losses, grads, ref_after = reference_steps(run, n, k0, leaves)
        if control:
            losses, _, after = reference_steps(run, n, k0, leaves,
                                               control=True)
        gaps = _gaps(losses, ref_losses, start, after, ref_after, grads)
        names = (tag + "loss_gap", tag + "change_gap")
        run.readings.update(zip(names, gaps))
        if not all(run.readings[k] <= limits[k] for k in names):
            failed += n
    run.failed = failed
    run.prog = None
