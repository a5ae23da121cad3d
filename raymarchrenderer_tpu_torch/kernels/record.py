"""The recording megakernel: the differentiable forward's march, in one
launch.

`trace_record_fused` runs the RGB megakernel schedule over a patch (every
lane traces its samples with in-loop regeneration, shadow rays as extra
segments) and banks exactly what the differentiable replay
(`render.integrator.trace_rgb(march_impl="recorded")`) needs in place of
its marches:

    t, mid, hit     per (bounce, path) slot    the march residuals
    sd              per (bounce, path, light)   NEE visibility, saturated:
                                                3.4e38 when lit, 0 when
                                                occluded

It ports the JAX package's `kernels/record.py::trace_record_fused` in mega
mode (the TPU kernel `_record_mega`); the wavefront mode (no CLI path
reaches it) is the next slice's.  CUDA tensors launch the recording entry
of `csrc/mega_paths.cu` (`RECORD_PATHS`); CPU tensors run its plain
version `render.mega.trace_mega_paths(record_banks=True)`.  Everything is
detached: gradients come from the replay.
"""
from __future__ import annotations

import ctypes

import torch

from raymarchrenderer_tpu_torch.kernels.march import (
    DEFAULT_LAZY_MISS, DEFAULT_MARCH_UNROLL, DEFAULT_REGEN_CADENCE,
    RECORD_PATHS, paths_launch, stream_args)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.mega import (check_paths_supported,
                                                    trace_mega_paths)
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.scene.graph import Scene

SD_LIT = 3.4e38     # the banked visibility of a lit shadow ray


def record_knobs(device, nee: bool):
    """(march_unroll, regen_cadence, lazy_miss) of a recording launch, the
    JAX package's rule keyed on the device where it keys on `interpret`:
    on the card the production schedule (unroll 32, a cheap pass every 16
    steps, the lazy miss test unless NEE: lazy recording flips a few
    shadow verdicts); on the CPU unroll 1, no cadence, strict."""
    if torch.device(device).type == "cuda":
        return (DEFAULT_MARCH_UNROLL, DEFAULT_REGEN_CADENCE,
                DEFAULT_LAZY_MISS and not nee)
    return 1, 0, False


def _launch_record(scene, params, cfg, corners, origin_xy, ph, pw, sample0,
                   n_samples, direct_light, knobs):
    march_unroll, regen_cadence, lazy_miss = knobs
    args, prog, data = paths_launch(
        scene, params, cfg, corners, origin_xy, ph, pw, sample0, n_samples,
        direct_light, march_unroll, False, lazy_miss, regen_cadence)
    device = corners.device
    bp = cfg.max_bounces * (3 * n_samples if args.dispersion else n_samples)
    shape = (bp, ph, pw)
    t = torch.full(shape, cfg.max_dist, dtype=torch.float32, device=device)
    mid = torch.full(shape, -1, dtype=torch.int32, device=device)
    hit = torch.zeros(shape, dtype=torch.int32, device=device)
    sd = torch.full((bp * args.n_lights, ph, pw), SD_LIT,
                    dtype=torch.float32, device=device)
    RECORD_PATHS.launch(ctypes.byref(args), corners.contiguous().data_ptr(),
                        data.data_ptr(), prog.data_ptr(), t.data_ptr(),
                        mid.data_ptr(), hit.data_ptr(), sd.data_ptr(),
                        *stream_args(device))
    return (t, mid, hit, sd) if args.n_lights else (t, mid, hit)


def trace_record_fused(scene: Scene, params, cfg: RenderConfig, corners,
                       origin_xy, patch_shape, sample0, n_samples: int = 1,
                       direct_light: bool = False, mode: str = "mega"):
    """Record every (sample, bounce) march of the (ph, pw) patch at
    `origin_xy` (x, y), samples `sample0 .. sample0 + n_samples - 1`, in
    `render_patch_spp`'s sample-folded layout:

        {"t": (B, S*ph, pw) float32, "mid": int32, "hit": int32 (0/1),
         "sd": (B*L, S*ph, pw) float32}          # sd only with NEE

    B = cfg.max_bounces, L the scene's lights; slot b*L + li of `sd` is
    bounce b's shadow ray toward light li.  With dispersion every bank
    gains a leading channel axis of 3.  A slot no path reaches keeps the
    march's miss values (t = max_dist, mid = -1, hit = 0, sd lit)."""
    if mode not in ("auto", "mega"):
        raise NotImplementedError(
            f"mode={mode!r}: the wavefront recorder is not ported yet (the "
            "next slice, with the spectral recorder)")
    check_paths_supported(scene, cfg)
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if corners.device.type == "cpu":
        return record_plain(scene, params, cfg, corners, origin_xy,
                            patch_shape, sample0, n_samples, direct_light)
    if corners.device.type != "cuda":
        raise ValueError(f"no route for device {corners.device}")
    ph, pw = patch_shape
    nee = bool(direct_light) and scene.n_lights > 0
    with torch.no_grad():
        banks = _launch_record(scene, params, cfg, corners, origin_xy, ph, pw,
                               sample0, int(n_samples), direct_light,
                               record_knobs(corners.device, nee))
    return fold_banks(banks, cfg.max_bounces, int(n_samples), ph, pw,
                      bool(cfg.separate_channels))


def record_plain(scene: Scene, params, cfg: RenderConfig, corners,
                 origin_xy, patch_shape, sample0, n_samples: int = 1,
                 direct_light: bool = False, work: dict = None):
    """The plain version of `trace_record_fused` on the corners' device,
    with the knobs a recording launch takes there (`record_knobs`): the
    CPU route, and on the card the kernel's yardstick.  `work` counts the
    map evaluations as `trace_mega_paths` does."""
    check_paths_supported(scene, cfg)
    ph, pw = patch_shape
    S = int(n_samples)
    nee = bool(direct_light) and scene.n_lights > 0
    unroll, cadence, lazy = record_knobs(corners.device, nee)
    px, py = pixel_grid(pw, ph, corners.device, origin_xy)
    with torch.no_grad():
        _, banks = trace_mega_paths(
            scene, params, cfg, corners, px, py, sample0, n_samples=S,
            march_unroll=unroll, regen_cadence=cadence, lazy_miss=lazy,
            dispersion=cfg.separate_channels, direct_light=direct_light,
            record_banks=True, work=work)
    return fold_banks(banks, cfg.max_bounces, S, ph, pw,
                      bool(cfg.separate_channels))


def fold_banks(banks, B: int, S: int, h: int, w: int, dispersion: bool):
    """The stacked (slot, h, w) banks of a recording launch -> the replay's
    layout.  Slot b*P + p (P = S paths, or 3S (sample, channel) pairs with
    dispersion); sd slot (b*P + p)*L + li."""
    names = ("t", "mid", "hit", "sd")
    if dispersion:
        # slot b*3S + 3s + ci -> per channel (3, B, S*h, w)
        rec = {k: a.reshape(B, S, 3, h, w).permute(2, 0, 1, 3, 4)
               .reshape(3, B, S * h, w) for k, a in zip(names, banks[:3])}
        if len(banks) == 4:
            L = banks[3].shape[0] // (3 * B * S)
            rec["sd"] = (banks[3].reshape(B, S, 3, L, h, w)
                         .permute(2, 0, 3, 1, 4, 5)
                         .reshape(3, B * L, S * h, w))
        return rec
    rec = {k: a.reshape(B, S * h, w) for k, a in zip(names, banks[:3])}
    if len(banks) == 4:
        L = banks[3].shape[0] // (B * S)
        # slot (b*S + s)*L + li -> (B*L, S*h, w) with replay index b*L + li
        rec["sd"] = (banks[3].reshape(B, S, L, h, w).permute(0, 2, 1, 3, 4)
                     .reshape(B * L, S * h, w))
    return rec
