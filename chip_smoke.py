"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # exits 0 when every phase passes

Phases (any failure raises and the script exits non-zero):

  1. device — a CUDA card must be present; print its name and power limit;
  2. build  — compile csrc/mega_paths.cu (the render with the constant
     and the SH sky, the deferred-sky render and the recording entry),
     csrc/wavefront_paths.cu (the RGB wavefront render and the wavefront
     recorder),
     csrc/mega_spectral.cu (the render and the recording entries),
     csrc/wavefront_spectral.cu and csrc/march_fused.cu with nvcc
     (sm_90a), one process per source, started together; time each and
     print every instantiation's registers and spills (ptxas) and its
     SASS local loads and stores, calls and indirect branches
     (cuobjdump) beside the values before the redesign of the render
     megakernels (`PTXAS_BEFORE`, `SASS_BEFORE`): each source holds a
     stencil and an exact-normal (`normal_taps=0`, `grad_map`)
     instantiation of each kernel;
  2b. native — the host libraries of native/ (image encoder, .hdr
     decoder, spiral scheduler) built by g++ into build/, all started
     together (`io/native_bindings.py`); the run fails if one does not
     build, and the main paths' `save_image` and the tiles' spiral must
     have called them;
  3. parity — each kernel's wrapper on CUDA tensors against its plain
     PyTorch version on the same tensors, production knobs:
       * RGB (`render_fused_patch` vs `trace_mega_paths`): the main path's
         own launch (sphere_on_floor, the whole 1024^2 frame, origin
         (0, 0), 128 samples); csg_demo with NEE on a 256^2 patch at a
         non-zero origin, 8 samples; csg_demo with dispersion, NEE and
         Russian roulette on a 128^2 patch, 2 samples;
       * spectral (`render_fused_spectral` vs `trace_mega_spectral`): the
         main path's own launch (spectral_demo, 1024^2, 128 samples), then
         a 128^2 patch at a non-zero origin, 4 samples.
       * the recorder (`trace_record_fused` vs `record_plain`): the train
         path's own launch (sphere_on_floor, 1024^2, 4 samples, 4
         bounces, relax 1.9, 4 taps); csg_demo with NEE on a 256^2 patch,
         2 samples (the sd bank, strict miss test); csg_demo with
         dispersion, NEE and roulette on a 128^2 patch, 1 sample;
       * `march_fused` vs `integrator.march`: the train launch's
         sample-folded primary plane (4 * 1024, 1024), a shadow-style
         plane (per-lane t_max, a quarter of the rays inside the ball
         with dist_mult -1, an eighth inactive), and one of 333 x 1021
         rays (no multiple of 128); the chain occupancy of its schedules
         from the plain march's per-lane steps (`march_occupancy`);
       * gradients: one train step at 256^2, 2 samples, replayed over the
         recorder's banks and over its plain version's, and with
         `march_fused` against the plain march;
       * the spectral recorder (`trace_record_fused_spectral` vs
         `record_spectral_plain`): the spectral train path's own launch
         (spectral_demo, 1024^2, 4 samples, 4 bounces, relax 1.9, 4 taps;
         its lane occupancy, one lane per pixel and on the pixel queue),
         and a 128^2 patch at a non-zero origin, 4 samples;
       * the wavefront recorder (`trace_record_wavefront` vs
         `record_wavefront_plain`): the train launch's bounce-0 planes
         (sphere_on_floor, 1024^2, 1 sample, 4 bounces) and csg_demo with
         NEE and roulette from bounce 1 on the same planes (the NEE
         launch), each timed with its bound and the chain occupancy of
         its schedules (`wavefront_occupancy`: one thread per ray, one
         lane per ray, the ray queue modelled; warps of 32 consecutive
         rays);
         csg_demo with NEE and roulette on a 256^2 patch, and there
         against the mega
         recorder on the same rays (decisions and visibility off on fewer
         than 5e-3 of the entries, bounce-0 t within 5e-3, later t off by
         more than 1e-5 on fewer than 1e-3 of the both-hit entries);
       * spectral gradients: one spectral train step at 256^2, 2 samples,
         replayed over the spectral recorder's banks and over its plain
         version's (scene leaves and band rows);
       * the deferred sky (`_launch_mega_defer` vs `_mega_defer_plain`):
         the env main path's own launch (default.scene under bench.py's
         512 x 1024 gradient sky, 1024^2, 32 paths: raw sum, banks,
         composite image; the composite timed alone), a two-sphere NEE
         scene under a random 64 x 128 image on a 256^2 patch with the
         exact and the "mxu" composite, and dispersion + NEE + roulette
         on a 128^2 patch, 11 samples (a chunk and a tail launch,
         against the same chunks on the plain version);
       * the SH sky in the RGB kernel on a 256^2 patch, 16 samples;
       * the wavefront entries at the full 16 bounces: the RGB one at its
         main path's own launch (sphere_on_floor, 1024^2, 8 samples; the
         chain occupancy of the nested loops, of its lane machine and of
         the pixel queue from the plain version's per-lane steps,
         `wavefront_occupancy`), on
         128^2 patches with NEE, dispersion and roulette (3 samples) and
         under the gradient sky (11 samples: 8 slots, then n_valid 3 of
         8); the spectral one at its main path's launch (1024^2, 8
         samples; its chain occupancy as the RGB one's) and on a 128^2
         patch at a non-zero origin, 3 samples;
       * the exact normal (`normal_taps=0`) in every shading kernel, each
         on a 128^2 patch at a non-zero origin against its plain version
         (torch.autograd's reverse sweep of the map): the RGB render (csg
         with NEE, dispersion and roulette), the SH sky, the deferred sky
         (banks and composite), the RGB wavefront entry (NEE, roulette),
         the spectral render and its wavefront entry, and the three
         recorders; each timed (kernel mean of 3, plain one run that also
         counts the work) with its bound.
       * the scenes the kernels once refused (`tests/_torch_scenes.py`): a
         40-node object in the RGB megakernel (4 taps and the exact
         normal), the spectral one and the recorder, and 12 lights under
         NEE in the RGB megakernel and the recorder, on 128^2 patches;
       * lane occupancy at the RGB, spectral, deferred and spectral
         recorder main launches (chain, march and shade, counted by the
         plain versions), and the same modelled on the pixel queue;
       * every kernel at its main launch alone (`kernel_times`: mean of
         3 beside the times recorded before the redesign, `BEFORE_MS`;
         csg NEE, the SH sky and the exact normal's launches with bounds
         scaled from an 8-sample run of their plain versions, the
         wavefront recorder's two launches with the parity phase's).
     Bars: without NEE the JAX package's kernel bar, fewer than 1e-3 of the
     values off by more than 1e-5; with NEE its NEE bar, fewer than 1e-3
     off by more than 1e-3 and rtol 5e-3 / atol 1e-3.  Banks and march
     planes: fewer than 1e-3 of the entries with another material, hit or
     visibility, and fewer than 1e-3 of those where both hit with t off by
     more than 1e-5.  Packed (u, v) banks: equal on all but 1e-3 of the
     live slots, at most one bin apart; env composites: the JAX package's
     env bar, fewer than 1e-3 of the values off by more than 1e-3.  Gradients: loss to rtol 1e-5, each leaf to atol
     1e-3 * max|g|.  The main launches are timed (CUDA events), and a
     second run of the plain version there counts the map evaluations
     these inputs need, for the kernel's operation bound (the main
     launches' plain versions, 35-80 s each at 1024^2, count in their
     timed run);
  4. main paths — the port's CLI in-process, each with its kernel's launch
     counter zeroed just before and read just after:
       render --spectral --scene data/scenes/spectral.scene ...
       render --scene sphere_on_floor ...
       render --scene csg --direct-light ...
       render --scene data/scenes/default.scene --env-map SKY.hdr ...
       render --scene SH.scene ...    (default.scene with environment.sh)
     all at --width 1024 --height 1024 --spp 128 --chunk 128 --relax 2.0
     --normal-taps 4; the counter must have risen, the image be finite and
     non-zero and the PNG written; then `train` (RGB inverse rendering),
     --spp 4 --max-bounces 4 --relax 1.9 --normal-taps 4 --steps 3
     --lr 1e-2 toward a target the port renders itself (the scene with a
     radius scaled by 1.05, 64 samples):
       train --scene sphere_on_floor --width 1024 --height 1024
       train --scene sphere_on_floor --impl fused --width 1024 --height 1024
       train --scene csg --direct-light --width 512 --height 512
     the recorder must launch once per step (march_fused once per march,
     its every launch's plane, active lanes and ms printed in a `train
     --impl fused launches:` line) and the RGB kernel for the final
     render, the loss and every
     gradient be finite, a gradient that must not vanish not vanish, and
     the npz and PNG be written; then `train --spectral` with the same
     flags toward the port's own spectral render with the sphere row's
     band ending at 620 nm instead of 590 (64 samples):
       train --spectral --scene sphere_on_floor --width 1024 --height 1024
       train --spectral --scene sphere_on_floor --impl fused --width 256
             --height 256
     the spectral recorder must launch once per step (or march_fused) and
     the spectral kernel for the final render, the band rows' gradients be
     non-zero, the rows stay in [380, 830] nm and the npz hold the JAX
     keys; the wavefront recorder through its entry point (no CLI
     verb reaches it) on the train launch's primary planes, one launch;
     `render --env-map` must make 4 launches of the deferred-sky kernel
     and none of the constant-sky one (kernel and composite times by
     CUDA events around each call, one `env perf:` JSON line); then
       train --env-map SKY.hdr --scene data/scenes/default.scene
             --width 256 --height 256 ...
     toward the scene with its sphere's albedo x 1.5: 3 recorder
     launches, the deferred kernel for the final render, the env image's
     gradient non-zero and the printed loss falling; and the wavefront
     modes through the library API at 1024^2, 8 samples (RGB constant
     sky, RGB under the gradient sky, spectral), one launch each; then
     the exact normal's main paths: `render --spectral`, `render`
     (sphere_on_floor) and `render --env-map` with `--normal-taps 0` at
     the same 1024^2, 128 spp (launches counted, the env one timed), and
       train --scene csg --direct-light --normal-taps 0 --width 256
             --height 256 ...
     toward csg with its floor's albedo x 1.5: 3 recorder launches, the
     render kernel for the final image, the smooth union's radius
     gradient non-zero (NEE's cos term differentiates the normal) and the
     printed loss falling;
  4b. the drivers — `ProgressiveRenderer(impl="fused")` through the
     reference's spiral of 16 tiles of 256^2, byte-equal to one full-frame
     launch (sphere_on_floor at 128 spp, csg with NEE at 8) and its
     `endless_passes(2)` to the running mean of full-frame launches, 16
     launches a pass; `render --checkpoint` at 64 spp and `--resume --spp
     128` through the CLI at 1024^2, --chunk 64, spectral and RGB,
     byte-equal to the uninterrupted run, another scene's checkpoint
     refused; bench.py's work counters (`utils.metrics`
     `spectral_path_profile`, 4 samples, within 0.1% of BENCH_r05.json)
     and march occupancy (`mega_occupancy_profile`, 4 tiles of 128
     samples, within 0.002), plain versions run eagerly while phase 2's
     nvcc processes build, since they need no kernel (readings in
     smoke_out/drivers.json);
  4c. the frontends — each verb through `cli.main`, its kernels' launch
     counters zeroed just before and read just after: `bench --size 1024
     --spp 128` (BENCH_PROFILE=0; 3 spectral launches, its JSON line
     beside phase 4's spectral rate); the viewer (`app.viewer`, port 0,
     on the card) in a thread over HTTP: spectral 1024^2 at 128 spp (32
     launches of 4, byte-equal to `render_progressive_fused_spectral` in
     launches of 4), csg with NEE at 512^2, 16 spp (4 launches, byte-equal
     to the same chunks), an orbit that restarts it, a reset that gives
     its bytes again, default.scene under the gradient sky (4 deferred
     launches, none of the constant sky) and a stop that keeps the
     partial image; `repl` (samples 128, 1024^2, a 4 x 4 grid, render,
     save: 16 launches, byte-equal to one full-frame launch); `info`;
     `parity` (`run_parity` at the x4 goldens, 2048 spp: exit code 0, all
     five gated goldens pass); `render --spectral --metrics --profile` at
     the headline (the JSONL events, and the trace's `record_function`
     span of `rmr_mega_spectral` and its count of GPU kernel events); and
     `checked_render_sample` on the card at 64^2 (clean parameters pass,
     NaN parameters raise); the phase's seconds (readings in
     smoke_out/frontends.json);
  5. perf — each kernel and its plain version at 1024^2 with 8 samples per
     launch (the CLI's default chunk), the RGB kernel at 128, and both
     render kernels at 128 with the exact normal, one
     `perf:` JSON line; then the train step at the full configuration
     (recorder, replay forward, the whole step, its rate, peak memory with
     and without remat), one `train perf:` JSON line, the `train --impl
     fused` step and its march_fused launches, one `train perf (fused):`
     JSON line, the spectral
     train step likewise, one `spectral train perf:` JSON line, and the
     `train --env-map` step at 256^2 and 1024^2 beside the same scene
     under its constant sky, one `env train perf:` JSON line.

Every output a parity check sees, every main path's image and every
`kernel_times` launch is digested (SHA-256) and held against
`DIGESTS_BEFORE`, taken on the tree before the redesign: under the same
nvcc (`NVCC_BEFORE`) a differing byte fails the run; under another the
differences are printed and the plain-version bars decide.  The JSON
readings go to smoke_out/.

    python3 chip_smoke.py --frontends           # build the render
                                                # kernels, phase 4c alone
    python3 chip_smoke.py --kernel-times        # build, counts, times,
                                                # digests; no plain version
    python3 chip_smoke.py --kernel-times --only march_fused,wavefront_paths
    python3 chip_smoke.py --sweep-min-blocks 4,6,8   # each source's launch
                                                # bound, one source a build
    python3 chip_smoke.py --sweep-const kWaveUnroll=4,16   # a schedule
                                                # constant of csrc/

Run `--kernel-times` in a checkout of another commit (`git archive`),
with this script copied in, to time both trees in one call.

The line before the last is a JSON object with one entry per kernel of the
paths (each shading kernel's with a `normal_taps_0` note: its
exact-normal patch's max error, times and bound, and its launches on the
exact-normal main path where one runs it; march_fused's with a
`train_step` note: the 8 launches of one `train --impl fused` step, their
ms, bound and max abs error against the plain march); the last line is
{"ok": true, "device": {...}}.  A run with a mode flag checks only that
mode and ends in {"ok": true, "partial": "<mode>", "device": {...}}.
Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.abspath(__file__))

PIX_TOL = 1e-5
MAX_FRAC_OFF = 1e-3
_SPEC_PATCH = (448, 512)      # (x, y) of the spectral 128^2 parity patch
_NEE_PATCH = (384, 512)       # (x, y) of the 256^2 NEE parity patch
_DISP_PATCH = (448, 448)      # (x, y) of the 128^2 dispersion patch
_SIZE = ["--width", "1024", "--height", "1024", "--spp", "128", "--chunk",
         "128", "--relax", "2.0", "--normal-taps", "4"]
SPECTRAL_ARGV = ["render", "--spectral", "--scene",
                 os.path.join(_ROOT, "data", "scenes", "spectral.scene"),
                 *_SIZE]
RGB_ARGV = ["render", "--scene", "sphere_on_floor", *_SIZE]
NEE_ARGV = ["render", "--scene", "csg", "--direct-light", *_SIZE]
_TRAIN = ["--spp", "4", "--max-bounces", "4", "--relax", "1.9",
          "--normal-taps", "4", "--steps", "3", "--lr", "1e-2"]
TRAIN_ARGV = ["train", "--scene", "sphere_on_floor", "--width", "1024",
              "--height", "1024", *_TRAIN]
TRAIN_FUSED_ARGV = ["train", "--scene", "sphere_on_floor", "--impl", "fused",
                    "--width", "1024", "--height", "1024", *_TRAIN]
TRAIN_NEE_ARGV = ["train", "--scene", "csg", "--direct-light", "--width",
                  "512", "--height", "512", *_TRAIN]
TRAIN_SPECTRAL_ARGV = ["train", "--spectral", "--scene", "sphere_on_floor",
                       "--width", "1024", "--height", "1024", *_TRAIN]
TRAIN_SPECTRAL_FUSED_ARGV = ["train", "--spectral", "--scene",
                             "sphere_on_floor", "--impl", "fused", "--width",
                             "256", "--height", "256", *_TRAIN]
TRAIN_SPP = 4
ENV_ARGV = ["render", "--scene", os.path.join(_ROOT, "data", "scenes",
                                              "default.scene"), *_SIZE]
ENV_TRAIN_ARGV = ["train", "--scene", os.path.join(_ROOT, "data", "scenes",
                                                   "default.scene"),
                  "--width", "256", "--height", "256", *_TRAIN]


def exact(argv):
    """`argv` with the exact normal: --normal-taps 0 for 4."""
    i = argv.index("--normal-taps")
    return argv[:i + 1] + ["0"] + argv[i + 2:]


TRAIN_EXACT_ARGV = exact(["train", "--scene", "csg", "--direct-light",
                          "--width", "256", "--height", "256", *_TRAIN])

# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
PEAK_FP32 = 67e12             # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
MARCH_STEP_FLOPS = 8          # p = o + d*t, t += step


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _main_cfg(**kw):
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    kw.setdefault("normal_taps", 4)
    return RenderConfig(width=1024, height=1024, spp=128, relax_omega=2.0,
                        **kw)


def _knobs():
    from raymarchrenderer_tpu_torch.kernels import march
    return dict(march_unroll=march.DEFAULT_MARCH_UNROLL,
                lazy_miss=march.DEFAULT_LAZY_MISS,
                regen_cadence=march.DEFAULT_REGEN_CADENCE)


def _mean(c, n):
    inv = float(np.float32(1.0 / n))
    return torch.stack([c.x * inv, c.y * inv, c.z * inv], dim=-1)


def _paths_fns(dev, scene_name, n, origin_xy=(0, 0), patch_shape=None,
               direct_light=False, **cfg_kw):
    """(kernel, plain, scene, cfg, params) for the RGB path on a builtin
    scene or a `.scene` file: the wrapper
    on CUDA tensors and the plain version on the same tensors, each
    returning the (ph, pw, 3) mean over `n` samples from sample 0; `plain`
    takes an optional work-count dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_paths
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.scene import builtin, load_scene

    scene = (load_scene(scene_name) if scene_name.endswith(".scene")
             else getattr(builtin, scene_name)())
    params = scene.init_params(dev)
    cfg = _main_cfg(**cfg_kw)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    ph, pw = patch_shape or (cfg.height, cfg.width)

    def kernel():
        return march.render_fused_patch(
            scene, params, cfg, corners, origin_xy, (ph, pw), 0,
            n_samples=n, direct_light=direct_light, **_knobs())

    def plain(work=None):
        px, py = pixel_grid(pw, ph, dev, origin_xy)
        return _mean(trace_mega_paths(
            scene, params, cfg, corners, px, py, 0, n_samples=n,
            dispersion=cfg.separate_channels, direct_light=direct_light,
            work=work, **_knobs()), n)

    return kernel, plain, scene, cfg, params


def _spectral_fns(dev, n, origin_xy=(0, 0), patch_shape=None, **cfg_kw):
    """As `_paths_fns`, for the spectral path on spectral_demo()."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_spectral
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    cfg = _main_cfg(**cfg_kw)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    ph, pw = patch_shape or (cfg.height, cfg.width)

    def kernel():
        return march.render_fused_spectral(
            scene, params, mats, cfg, corners, 0, n_samples=n,
            origin_xy=origin_xy, patch_shape=patch_shape, **_knobs())

    def plain(work=None):
        px, py = pixel_grid(pw, ph, dev, origin_xy)
        return _mean(trace_mega_spectral(
            scene, params, mats, cfg, corners, px, py, 0, n_samples=n,
            work=work, **_knobs()), n)

    return kernel, plain, scene, cfg, (params, mats)


def _compare(label, got, want, nee=False):
    """Hold the kernel's image against the plain version's; returns the
    max abs error.  `nee` selects the NEE bar."""
    torch.cuda.synchronize()
    _digest(label, got)
    diff = (got - want).abs()
    frac = float((diff > PIX_TOL).float().mean())
    frac3 = float((diff > 1e-3).float().mean())
    max_err = float(diff.max())
    finite = bool(torch.isfinite(got).all())
    if nee:
        ok = frac3 < MAX_FRAC_OFF and bool(torch.allclose(
            got, want, rtol=5e-3, atol=1e-3))
        bar = f"NEE bar: off by > 1e-3 {frac3:.3e} (< {MAX_FRAC_OFF:g})"
    else:
        ok = frac < MAX_FRAC_OFF
        bar = f"bar {MAX_FRAC_OFF:g}"
    print(f"parity, {label}: fraction off by > {PIX_TOL:g}: {frac:.3e} "
          f"({bar}), max abs err {max_err:.3e}, kernel mean "
          f"{float(got.mean()):.6f}, plain mean {float(want.mean()):.6f}",
          flush=True)
    if tuple(got.shape) != tuple(want.shape) or not finite or not ok:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({label}): shape {tuple(got.shape)}, "
                             f"finite={finite}, fraction={frac}")
    return max_err


def _bound(scene, cfg, work, in_bytes, out_bytes, lookups=1):
    """The least time the card could take for one launch: the larger of
    its bytes (each input read once, each output written once) over the
    HBM rate and its FP32 operations over the FP32 peak.  Operations are
    the map evaluations these inputs need, as counted by the plain version
    (march steps of live lanes, and per shaded hit `lookups` material
    lookups, 1 for the megakernels and 0 where the march returns the
    material, and `normal_taps` taps, 2 for the exact normal's reverse
    sweep as the JAX package's utils/metrics.py counts it), times the
    object program's FP32 cost; integer RNG hashing and material
    arithmetic are left out, so the bound is low.  Returns (ms, "bytes" or
    "operations", operations)."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import map_flops
    mf = map_flops(scene)
    march, shade = int(work["march"]), int(work.get("shade", 0))
    taps = cfg.normal_taps or 2
    ops = (march * (mf + MARCH_STEP_FLOPS)
           + shade * ((lookups + taps) * mf + 6 * taps + 11))
    t_ops, t_bytes = ops / PEAK_FP32, (in_bytes + out_bytes) / PEAK_BYTES
    print(f"bound: {march} march and {shade} shade evaluations of a "
          f"{mf}-FLOP map, {ops:.4e} FP32 ops = {t_ops * 1e3:.3f} ms; "
          f"{in_bytes + out_bytes} bytes = {t_bytes * 1e3:.4f} ms",
          flush=True)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops)


def _main_launch(label, kernel, plain, card, compare=_compare,
                 count_apart=True, work=None):
    """Kernel vs plain at a main path's own launch: parity by `compare`,
    the kernel's time (mean of 3), the plain version's time (one run),
    then one more plain run that counts the work for the bound, outside
    that time.  With `count_apart` false the timed run also counts (for
    plain versions that take minutes; the counters add one reduction per
    march step).  `work` seeds the count (a "lane_steps" list gathers the
    marches' per-lane steps).  Returns (max abs error, ms, plain ms,
    work)."""
    got = kernel()
    work = {} if work is None else work
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain() if count_apart else plain(work)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    max_err = compare(label, got, want)
    del got, want
    ms = _cuda_ms(kernel, reps=3, warmup=False)
    if count_apart:
        count_ms = _cuda_ms(lambda: plain(work), reps=1, warmup=False)
        counted = f"with work counters {count_ms:.3f} ms"
    else:
        counted = "the same run counted the work"
    print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({counted}) "
          f"[{card}]", flush=True)
    return max_err, ms, plain_ms, work


def _buffer_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- readings: output digests, SASS, lane occupancy ------------------------

DIGESTS = {}        # label -> SHA-256 (16 hex digits) of a kernel's output


def _digest(label, *tensors):
    """Record the SHA-256 of the bytes of a kernel launch's outputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    DIGESTS[label] = h.hexdigest()[:16]


def _nvcc_version() -> str:
    """The last line of `nvcc --version` (its build tag)."""
    from raymarchrenderer_tpu_torch.kernels.build import find_nvcc
    out = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def check_digests(nvcc: str) -> None:
    """Hold this run's digests against DIGESTS_BEFORE: with the nvcc that
    made them, every label both runs hold must match byte for byte; with
    another nvcc the mismatches are printed and the plain-version bars
    alone decide."""
    both = sorted(set(DIGESTS) & set(DIGESTS_BEFORE))
    off = [k for k in both if DIGESTS[k] != DIGESTS_BEFORE[k]]
    print(f"digests: {len(both) - len(off)} of {len(both)} outputs "
          f"bit-identical to DIGESTS_BEFORE, {len(off)} differ, "
          f"{len(set(DIGESTS) - set(DIGESTS_BEFORE))} new; nvcc {nvcc!r} "
          f"(recorded {NVCC_BEFORE!r})", flush=True)
    for k in off:
        print(f"digest differs: {k}: {DIGESTS[k]} (before "
              f"{DIGESTS_BEFORE[k]})", flush=True)
    _log_json("digests", DIGESTS)
    if off and nvcc == NVCC_BEFORE:
        raise AssertionError(f"{len(off)} kernel outputs differ from "
                             "DIGESTS_BEFORE under the same nvcc")


def _log_json(name, obj) -> None:
    """Write `obj` to smoke_out/<name>.json in the checkout (the digests
    and readings are longer than a log's tail keeps)."""
    out = os.path.join(_ROOT, "smoke_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)


SASS_OPS = ("LDL", "STL", "CALL", "BRX")


def sass_counts(lib) -> dict:
    """{mangled kernel: {op: count}} of the local-memory loads and stores,
    calls and indirect branches in the SASS of a built library, from
    cuobjdump beside nvcc ({} where the toolkit has none)."""
    from raymarchrenderer_tpu_torch.kernels.build import find_nvcc
    exe = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        exe = shutil.which("cuobjdump")
    if exe is None:
        return {}
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=600).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9]*)", line)
        if name is not None and m and m.group(1) in SASS_OPS:
            counts[name][m.group(1)] += 1
    return counts


def _tiles(x):
    """A (R, W) per-lane plane padded with zeros to whole 2 x 16 tiles (a
    warp of the kernels' pixel and ray order), as (R/2, 2, W/16, 16)."""
    ph, pw = x.shape
    x = torch.nn.functional.pad(x, (0, -pw % 16, 0, -ph % 2))
    return x.reshape(x.shape[0] // 2, 2, x.shape[1] // 16, 16)


def _in_queue_order(x):
    """The entries of a (R, W) per-lane plane in queue order: 2 x 16 tiles,
    row-major, lanes row-major inside a tile."""
    return _tiles(x).permute(0, 2, 1, 3).reshape(-1).tolist()


def _queue_lives(costs, resident_warps):
    """The summed lifetimes of `resident_warps` warps on a queue: every
    lane takes the next slot's cost from `costs` (in queue order) when its
    previous slot ends, all lanes advancing one unit per step; a warp
    lives until its last lane's last slot ends."""
    import heapq
    n_lanes = 32 * resident_warps
    heap = [(0, lane) for lane in range(n_lanes)]
    life = [0] * resident_warps
    for cost in costs:
        t, lane = heapq.heappop(heap)
        t += cost
        life[lane // 32] = max(life[lane // 32], t)
        heapq.heappush(heap, (t, lane))
    return sum(life)


def occupancy(label, work, march_unroll, source):
    """Lane utilisation of a one-thread-per-pixel launch of 16 x 8 blocks
    (a warp: 2 rows x 16 columns), from the plain version's counts: chain
    occupancy, the lanes' bodies over 32 x the bodies of each warp's
    longest lane; march occupancy, the marching lanes' steps over 32 x
    `march_unroll` x the warps' bodies; shade occupancy, the shaded hits
    over 32 x the warps' bodies.  Counts, not times.  Then the same on
    the pixel queue at the resident warps of `source`'s launch bound
    (`_BOUNDS`)."""
    b = work["lane_bodies"].to(torch.int64)
    warp_bodies = int(_tiles(b).amax(dim=(1, 3)).sum())
    res = {"chain": int(b.sum()) / (32 * warp_bodies),
           "march": int(work["march"]) / (32 * march_unroll * warp_bodies),
           "shade": int(work["shade"]) / (32 * warp_bodies),
           "lane_bodies": int(b.sum()), "warp_bodies": warp_bodies}
    print(f"occupancy, {label}: chain {res['chain']:.4f}, march "
          f"{res['march']:.4f}, shade {res['shade']:.4f} ({res['lane_bodies']}"
          f" lane bodies, {warp_bodies} warp bodies)", flush=True)
    OCCUPANCY[label] = res
    queue_occupancy(label, work, march_unroll, _resident_warps(source))
    return res


OCCUPANCY = {}

# each source's launch bound: (the file that holds it, its constant)
_BOUNDS = {"mega_paths": ("scene_map.cuh", "kMinBlocks"),
           "mega_spectral": ("mega_spectral.cu", "kMinBlocksSpectral"),
           "march_fused": ("scene_map.cuh", "kMinBlocksMarch"),
           "wavefront_paths": ("scene_map.cuh", "kMinBlocksWavefront"),
           "wavefront_spectral": ("wavefront_spectral.cu",
                                  "kMinBlocksWavefrontSpectral")}


# the schedule constants of csrc/ a sweep may set, by the source that reads
# them: each launch bound, and the steps a pass or a visit
_CONSTS = {const: src for src, (_, const) in _BOUNDS.items()}
_CONSTS.update(kWaveUnroll="wavefront_paths", kMarchUnroll="march_fused",
               kWaveUnrollSpectral="wavefront_spectral")


def _min_blocks(source: str) -> int:
    """A kernel's launch bound: its resident blocks per SM at its register
    cap (`_BOUNDS`: kMinBlocks of csrc/scene_map.cuh for the RGB lane
    machine, kMinBlocksSpectral of csrc/mega_spectral.cu, ...)."""
    from raymarchrenderer_tpu_torch.kernels.build import CSRC
    name, const = _BOUNDS[source]
    text = (CSRC / name).read_text()
    return int(re.search(rf"constexpr int {const} = (\d+);", text).group(1))


def _resident_warps(source: str) -> int:
    """The warps a persistent grid of `source` keeps resident at its
    launch bound (4 warps a block)."""
    return (4 * _min_blocks(source)
            * torch.cuda.get_device_properties(0).multi_processor_count)


def queue_occupancy(label, work, march_unroll, resident_warps):
    """The three occupancies of a persistent launch on the pixel queue,
    modelled from the plain version's per-pixel body counts: every lane of
    `resident_warps` warps takes queue slots in order (2 x 16 tiles,
    row-major, the kernel's order) as its chains end, all lanes running
    one body per step; a warp lives until its last lane's last chain ends.
    The occupancies are the lanes' bodies, marching steps and shaded hits
    over 32 (x `march_unroll`) x the warps' lifetimes in bodies."""
    b = work["lane_bodies"].to(torch.int64)
    lives = _queue_lives(_in_queue_order(b), resident_warps)
    res = {"chain": int(b.sum()) / (32 * lives),
           "march": int(work["march"]) / (32 * march_unroll * lives),
           "shade": int(work["shade"]) / (32 * lives),
           "resident_warps": resident_warps, "warp_bodies": lives}
    print(f"occupancy on the queue (modelled), {label}: chain "
          f"{res['chain']:.4f}, march {res['march']:.4f}, shade "
          f"{res['shade']:.4f} ({resident_warps} resident warps, {lives} "
          "warp bodies)", flush=True)
    OCCUPANCY[label + ", queue"] = res
    return res


def march_occupancy(label, steps):
    """Chain occupancy of `march_fused` on a (R, W) plane, from the plain
    march's per-lane steps (`march(with_steps=True)`; counts, the same on
    any card): the lanes' steps over 32 x the warps' lifetimes in steps,
    for one thread per ray with warps of 1 x 32 rays of a row (the
    kernel before the redesign) and of 2 x 16 tiles, and for the ray
    queue's persistent grid (modelled: a ray takes max(steps, 1) of its
    lane's steps, its slots in 2 x 16 tiles)."""
    s = steps.to(torch.int64)
    total = int(s.sum())
    strips = torch.nn.functional.pad(s, (0, -s.shape[1] % 32)).reshape(
        s.shape[0], -1, 32)
    warps = _resident_warps("march_fused")
    lives = _queue_lives(_in_queue_order(s.clamp(min=1)), warps)
    res = {"rows_1x32": total / (32 * int(strips.amax(-1).sum())),
           "tiles_2x16": total / (32 * int(_tiles(s).amax(dim=(1, 3)).sum())),
           "queue_2x16": total / (32 * lives), "steps": total,
           "rays": s.numel(), "resident_warps": warps}
    print(f"occupancy, {label}: chain, one thread per ray, 1 x 32 rows "
          f"{res['rows_1x32']:.4f}, 2 x 16 tiles {res['tiles_2x16']:.4f}; on "
          f"the ray queue (modelled) {res['queue_2x16']:.4f} ({total} steps "
          f"of {s.numel()} rays, mean {total / s.numel():.2f}, max "
          f"{int(s.max())}; {warps} resident warps)", flush=True)
    OCCUPANCY[label] = res
    return res


def _tile_warps(x):
    """A (R, W) per-lane plane as (n / 32, 32) warps of 2 x 16 tiles in
    the pixel queue's order (`_in_queue_order`), padded with zeros."""
    return _tiles(x).permute(0, 2, 1, 3).reshape(-1, 32)


def _ray_warps(x):
    """A per-ray plane flattened in the rays' order (the ray queue's) and
    padded with zeros to whole warps of 32 consecutive rays, as (n / 32,
    32)."""
    x = x.reshape(-1)
    return torch.nn.functional.pad(x, (0, -x.numel() % 32)).reshape(-1, 32)


def wavefront_occupancy(label, planes, source, warps=_tile_warps):
    """Chain occupancy of a wavefront kernel (`source`, whose launch bound
    sets the queue's resident warps) from the per-lane steps of every march
    its plain version made (`work["lane_steps"]`: one plane per bounce or
    shadow march of each sample): the lanes' steps over 32 x the warps'
    lifetimes in steps, for the nested loops (each march a loop the warp
    runs to its longest lane), the lane machine with one lane per pixel or
    ray (a warp lives as long as its longest chain of steps), and on the
    queue (modelled, slots handed out in order).  `warps` cuts a plane
    into the kernel's warps in its queue's order: 2 x 16 tiles of pixels
    (`_tile_warps`) or, for the wavefront recorder, 32 consecutive rays
    (`_ray_warps`).  Counts march steps only, not the events."""
    total, nested, chain = 0, 0, None
    for p in planes:
        p = p.to(torch.int64)
        total += int(p.sum())
        nested += int(warps(p).amax(-1).sum())
        chain = p if chain is None else chain + p
    resident = _resident_warps(source)
    lives = _queue_lives(warps(chain).reshape(-1).tolist(), resident)
    res = {"nested_loops": total / (32 * nested),
           "lane_machine": total / (32 * int(warps(chain).amax(-1).sum())),
           "queue": total / (32 * lives), "steps": total,
           "marches": len(planes), "mean_chain": total / chain.numel(),
           "max_chain": int(chain.max()), "resident_warps": resident}
    print(f"occupancy, {label}: chain over every march, nested "
          f"loops {res['nested_loops']:.4f}, lane machine one lane per "
          f"pixel or ray {res['lane_machine']:.4f}, on the queue (modelled) "
          f"{res['queue']:.4f} ({total} steps in {len(planes)} marches, "
          f"chain mean {res['mean_chain']:.2f}, max {res['max_chain']}; "
          f"{resident} resident warps)", flush=True)
    OCCUPANCY[label] = res
    return res


def parity_paths(dev, card):
    """The RGB kernel: the main path's launch, then the NEE and the
    dispersion + NEE + roulette patches."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers)
    kernel, plain, scene, cfg, params = _paths_fns(dev, "sphere_on_floor",
                                                   128)
    prog, data, _ = paths_buffers(scene, params, dev)
    in_bytes = 15 * 4 + _buffer_bytes(prog, data)
    max_err, ms, plain_ms, work = _main_launch(
        "RGB, sphere_on_floor 1024x1024, 128 spp (the main path's launch)",
        kernel, plain, card, count_apart=False)
    bound = _bound(scene, cfg, work, in_bytes, 1024 * 1024 * 3 * 4)
    occupancy("RGB main launch", work, _knobs()["march_unroll"],
              "mega_paths")

    kernel, plain, *_ = _paths_fns(dev, "csg_demo", 8, _NEE_PATCH,
                                   (256, 256), direct_light=True)
    max_err = max(max_err, _compare(
        f"RGB + NEE, csg_demo 256x256 patch at {_NEE_PATCH}, 8 spp",
        kernel(), plain(), nee=True))
    kernel, plain, *_ = _paths_fns(dev, "csg_demo", 2, _DISP_PATCH,
                                   (128, 128), direct_light=True,
                                   separate_channels=True, rr_start_bounce=1)
    max_err = max(max_err, _compare(
        f"RGB + dispersion + NEE + RR, csg_demo 128x128 patch at "
        f"{_DISP_PATCH}, 2 spp", kernel(), plain(), nee=True))
    return max_err, ms, plain_ms, bound


def parity_spectral(dev, card):
    """The spectral kernel: the main path's launch, then a 128^2 patch."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        spectral_buffers)
    kernel, plain, scene, cfg, (params, mats) = _spectral_fns(dev, 128)
    prog, data, _ = spectral_buffers(scene, params, mats, dev)
    in_bytes = 15 * 4 + _buffer_bytes(prog, data)
    max_err, ms, plain_ms, work = _main_launch(
        "spectral 1024x1024, 128 spp (the main path's launch)", kernel,
        plain, card, count_apart=False)
    bound = _bound(scene, cfg, work, in_bytes, 1024 * 1024 * 3 * 4)
    occupancy("spectral main launch", work, _knobs()["march_unroll"],
              "mega_spectral")
    kernel, plain, *_ = _spectral_fns(dev, 4, _SPEC_PATCH, (128, 128))
    max_err = max(max_err, _compare(
        f"spectral 128x128 patch at {_SPEC_PATCH}, 4 spp", kernel(),
        plain()))
    return max_err, ms, plain_ms, bound


def _train_cfg(size, **kw):
    """The train workload's configuration (`tools/train_bench.py`): 4
    bounces, relax 1.9, 4 normal taps, the CLI's other defaults."""
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    kw.setdefault("normal_taps", 4)
    return RenderConfig(width=size, height=size, max_bounces=4,
                        relax_omega=1.9, **kw)


def _planes_compare(label, got, want):
    """Hold a kernel's (t, mid, hit[, sd]) planes against the plain
    version's: decisions (material, hit, visibility) off on fewer than
    1e-3 of the entries, and t off by more than 1e-5 on fewer than 1e-3 of
    the entries where both hit.  Returns the max abs t error there."""
    torch.cuda.synchronize()
    if set(got) != set(want) or any(
            tuple(got[k].shape) != tuple(want[k].shape) for k in want):
        raise AssertionError(f"{label}: planes {sorted(got)} vs "
                             f"{sorted(want)} differ in name or shape")
    _digest(label, *(got[k] for k in sorted(got)))
    hit = (got["hit"] > 0) & (want["hit"] > 0)
    dt = torch.where(hit, (got["t"] - want["t"]).abs(), 0.0)
    dec = float(((got["mid"] != want["mid"])
                 | (got["hit"] != want["hit"])).float().mean())
    sd = (float((got["sd"] != want["sd"]).float().mean()) if "sd" in want
          else 0.0)
    n_hit = int(hit.sum())
    t_off = float((dt > PIX_TOL).sum()) / max(n_hit, 1)
    max_err = float(dt.max())
    print(f"parity, {label}: decisions off {dec:.3e}, sd off {sd:.3e}; "
          f"{n_hit} both-hit entries, t off by > {PIX_TOL:g} {t_off:.3e} "
          f"(bars {MAX_FRAC_OFF:g}), max abs t err {max_err:.3e}",
          flush=True)
    if not (n_hit > 0 and dec < MAX_FRAC_OFF and sd < MAX_FRAC_OFF
            and t_off < MAX_FRAC_OFF):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({label})")
    return max_err


def _record_fns(dev, scene_name, size, n, origin_xy=(0, 0),
                patch_shape=None, direct_light=False, **cfg_kw):
    """(kernel, plain, scene, cfg, params) of a recording launch: the
    wrapper on CUDA tensors and `record_plain` on the same tensors, each
    returning the folded banks; `plain` takes an optional work dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import (
        record_plain, trace_record_fused)
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = getattr(builtin, scene_name)()
    params = scene.init_params(dev)
    cfg = _train_cfg(size, **cfg_kw)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    shape = patch_shape or (size, size)

    def kernel():
        return trace_record_fused(scene, params, cfg, corners, origin_xy,
                                  shape, 0, n_samples=n,
                                  direct_light=direct_light)

    def plain(work=None):
        return record_plain(scene, params, cfg, corners, origin_xy, shape, 0,
                            n_samples=n, direct_light=direct_light, work=work)

    return kernel, plain, scene, cfg, params


def parity_record(dev, card):
    """The recorder: the train path's launch, then the NEE and the
    dispersion + NEE + roulette patches."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers)
    kernel, plain, scene, cfg, params = _record_fns(
        dev, "sphere_on_floor", 1024, TRAIN_SPP)
    prog, data, _ = paths_buffers(scene, params, dev)
    max_err, ms, plain_ms, work = _main_launch(
        f"recorder, sphere_on_floor 1024x1024, {TRAIN_SPP} samples, "
        f"{cfg.max_bounces} bounces (the train path's launch)", kernel,
        plain, card, _planes_compare)
    banks = 12 * cfg.max_bounces * TRAIN_SPP * 1024 * 1024
    bound = _bound(scene, cfg, work, 15 * 4 + _buffer_bytes(prog, data),
                   banks)
    kernel, plain, *_ = _record_fns(dev, "csg_demo", 1024, 2, _NEE_PATCH,
                                    (256, 256), direct_light=True)
    max_err = max(max_err, _planes_compare(
        f"recorder + NEE, csg_demo 256x256 patch at {_NEE_PATCH}, 2 "
        f"samples", kernel(), plain()))
    kernel, plain, *_ = _record_fns(dev, "csg_demo", 1024, 1, _DISP_PATCH,
                                    (128, 128), direct_light=True,
                                    separate_channels=True,
                                    rr_start_bounce=1)
    max_err = max(max_err, _planes_compare(
        f"recorder + dispersion + NEE + RR, csg_demo 128x128 patch at "
        f"{_DISP_PATCH}, 1 sample", kernel(), plain()))
    return max_err, ms, plain_ms, bound


def _shadow_plane(dev, h=512, w=1024, seed=5):
    """Camera rays, a quarter of them inside the ball with dist_mult -1,
    an eighth inactive, and a per-lane t_max in [2, 12] (the shadow
    rays' cap)."""
    from raymarchrenderer_tpu_torch.core.vecmath import Vec3
    rng = np.random.RandomState(seed)
    o = np.broadcast_to(np.float32([0.0, 4.0, -6.0]), (h, w, 3)).copy()
    d = (np.float32([0.0, -0.447, 0.894])
         + rng.uniform(-0.45, 0.45, (h, w, 3))).astype(np.float32)
    inside = rng.uniform(size=(h, w)) < 0.25
    o[inside] = np.float32([0.0, 1.0, 0.0]) + rng.uniform(
        -0.4, 0.4, (int(inside.sum()), 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return (Vec3(*(put(o[..., k]) for k in range(3))),
            Vec3(*(put(d[..., k]) for k in range(3))),
            put(np.where(inside, -1.0, 1.0)),
            torch.from_numpy(rng.uniform(size=(h, w)) >= 0.125).to(dev),
            put(rng.uniform(2.0, 12.0, (h, w))))


def _march_bytes(o, d, dist_mult, active, t_max):
    """The bytes one march must move (`_bound`): every ray's active flag
    and its three outputs (t, material index, hit: 9 bytes); each active
    ray's origin and direction, and its dist_mult and t_max where they are
    planes.  A number, or a plane expanded from one, is read once."""
    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    n = math.prod(shape)

    def plane(x):
        return (isinstance(x, torch.Tensor) and x.numel() == n
                and all(st != 0 for st, k in zip(x.stride(), x.shape)
                        if k > 1))

    act = torch.as_tensor(active).expand(shape)
    flag = act.element_size() if plane(active) else 0
    per_ray = [x.element_size() for x in (*o, *d, dist_mult, t_max)
               if plane(x)]
    once = 4 * sum(1 for x in (*o, *d, dist_mult, t_max)
                   if x is not None and not plane(x))
    return n * (flag + 9) + int(act.sum()) * sum(per_ray) + once


def _march_fns(dev):
    """(kernel, plain, scene, cfg, params, bytes) of `march_fused` on the
    train launch's sample-folded primary plane (4 * 1024, 1024), the bytes
    its march must move (`_march_bytes`); both take optional other planes
    (o, d, dist_mult, active, t_max), `plain` first a work dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.march import march_fused
    from raymarchrenderer_tpu_torch.render.integrator import march, spp_rays
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    cfg = _train_cfg(1024)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    _, _, _, eye, d = spp_rays(cfg, corners, (0, 0), (1024, 1024), 0,
                               TRAIN_SPP)
    act = torch.ones(eye.x.shape, dtype=torch.bool, device=dev)

    def planes(out):
        return {"t": out[0], "mid": out[1], "hit": out[2].int()}

    def kernel(o=eye, d=d, dm=1.0, act=act, t_max=None):
        return planes(march_fused(scene, params, cfg, o, d, dm, act,
                                  t_max=t_max))

    def plain(work=None, o=eye, d=d, dm=1.0, act=act, t_max=None):
        return planes(march(scene, params, cfg, o, d, dm, act, t_max=t_max,
                            work=work))

    return (kernel, plain, scene, cfg, params,
            _march_bytes(eye, d, 1.0, act, None))


def parity_march(dev, card):
    """`march_fused`: the train launch's primary plane, sample-folded
    (4 * 1024, 1024), its chain occupancy from the plain march's per-lane
    steps, then a shadow-style plane and one of 333 x 1021 rays (no
    multiple of 128)."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        object_buffers)
    kernel, plain, scene, cfg, params, nbytes = _march_fns(dev)
    max_err, ms, plain_ms, work = _main_launch(
        f"march_fused, the train launch's primary plane "
        f"({TRAIN_SPP}x1024, 1024)", kernel, plain, card, _planes_compare,
        work={"lane_steps": []})
    steps = work.pop("lane_steps")
    if steps:                   # a plain march that keeps per-lane steps
        march_occupancy(f"march_fused, the train launch's primary plane "
                        f"({TRAIN_SPP}x1024, 1024)", steps[0])
    prog, data, _ = object_buffers(scene, params, dev)
    bound = _bound(scene, cfg, work, nbytes + _buffer_bytes(prog, data), 0)
    o, d2, dm, act2, tmax = _shadow_plane(dev)
    steps = {"lane_steps": []}
    max_err = max(max_err, _planes_compare(
        "march_fused, a shadow-style plane (512, 1024): per-lane t_max, "
        "dist_mult -1 inside the ball, inactive lanes",
        kernel(o, d2, dm, act2, tmax), plain(steps, o, d2, dm, act2, tmax)))
    if steps["lane_steps"]:
        march_occupancy("march_fused, a shadow-style plane (512, 1024)",
                        steps["lane_steps"][0])
    o, d2, dm, act2, tmax = _shadow_plane(dev, 333, 1021, seed=6)
    max_err = max(max_err, _planes_compare(
        "march_fused, a shadow-style plane (333, 1021): no multiple of 128 "
        "rays", kernel(o, d2, dm, act2, tmax),
        plain(None, o, d2, dm, act2, tmax)))
    return max_err, ms, plain_ms, bound


def _grads_compare(label, got, want):
    """Loss to rtol 1e-5 and every leaf to atol 1e-3 * max|g|."""
    from raymarchrenderer_tpu_torch.scene import param_leaves
    (loss, grads), (want_loss, want_grads) = got, want
    worst = 0.0
    for g, w in zip(param_leaves(grads), param_leaves(want_grads)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: a gradient is not finite")
        if w.numel():
            scale = max(1e-6, float(w.abs().max()))
            worst = max(worst, float((g - w).abs().max()) / scale)
    rel = abs(float(loss) - float(want_loss)) / max(abs(float(want_loss)),
                                                    1e-30)
    print(f"parity, {label}: loss {float(loss):.8f} vs "
          f"{float(want_loss):.8f} (rel {rel:.2e}, bar 1e-5), worst leaf "
          f"error {worst:.2e} of its max|g| (bar 1e-3)", flush=True)
    if not (rel <= 1e-5 and worst <= 1e-3):
        raise AssertionError(f"gradients disagree ({label})")


def parity_grads(dev, card):
    """One train step's loss and gradients at 256^2, 2 samples: replayed
    over the recorder's banks and over its plain version's; and with
    `march_fused` against the plain march."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import (
        record_plain, trace_record_fused)
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        train_grads_sharded)
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    cfg = _train_cfg(256)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    target = torch.from_numpy(np.random.RandomState(3).uniform(
        0.0, 0.5, (256, 256, 3)).astype(np.float32)).to(dev)
    args = (scene, params, cfg, corners, target, 2)
    rec = (trace_record_fused, record_plain)
    banks = [f(scene, params, cfg, corners, (0, 0), (256, 256), 0,
               n_samples=2) for f in rec]
    _grads_compare("train step 256x256, 2 samples: kernel banks vs plain "
                   "banks", *(train_grads_sharded(
                       *args, march_impl="recorded", recorded=b)
                       for b in banks))
    _grads_compare("train step 256x256, 2 samples: --impl fused vs oracle",
                   *(train_grads_sharded(*args, march_impl=m)
                     for m in ("fused", "oracle")))


def _record_spectral_fns(dev, size, n, origin_xy=(0, 0), patch_shape=None,
                         **cfg_kw):
    """(kernel, plain, scene, cfg, (params, mats)) of a spectral recording
    launch on spectral_demo: the wrapper on CUDA tensors and
    `record_spectral_plain` on the same tensors, each returning the folded
    banks; `plain` takes an optional work dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import (
        record_spectral_plain, trace_record_fused_spectral)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    cfg = _train_cfg(size, **cfg_kw)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    shape = patch_shape or (size, size)

    def kernel():
        return trace_record_fused_spectral(scene, params, mats, cfg, corners,
                                           origin_xy, shape, 0, n_samples=n)

    def plain(work=None):
        return record_spectral_plain(scene, params, mats, cfg, corners,
                                     origin_xy, shape, 0, n_samples=n,
                                     work=work)

    return kernel, plain, scene, cfg, (params, mats)


def parity_record_spectral(dev, card):
    """The spectral recorder: the spectral train path's launch
    (spectral_demo, 1024^2, 4 samples, 4 bounces, relax 1.9, 4 taps; its
    lane occupancy from the plain version's counts, one lane per pixel and
    on the pixel queue), then a 128^2 patch at a non-zero origin, 4
    samples."""
    from raymarchrenderer_tpu_torch.kernels.record import record_knobs
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        spectral_buffers)
    kernel, plain, scene, cfg, (params, mats) = _record_spectral_fns(
        dev, 1024, TRAIN_SPP)
    prog, data, _ = spectral_buffers(scene, params, mats, dev)
    max_err, ms, plain_ms, work = _main_launch(
        f"spectral recorder, spectral_demo 1024x1024, {TRAIN_SPP} samples, "
        f"{cfg.max_bounces} bounces (the spectral train path's launch)",
        kernel, plain, card, _planes_compare)
    occupancy("spectral recorder main launch", work,
              record_knobs(dev, False)[0], "mega_spectral")
    banks = 12 * cfg.max_bounces * TRAIN_SPP * 1024 * 1024
    bound = _bound(scene, cfg, work, 15 * 4 + _buffer_bytes(prog, data),
                   banks)
    kernel, plain, *_ = _record_spectral_fns(dev, 1024, 4, _SPEC_PATCH,
                                             (128, 128))
    max_err = max(max_err, _planes_compare(
        f"spectral recorder, 128x128 patch at {_SPEC_PATCH}, 4 samples",
        kernel(), plain()))
    return max_err, ms, plain_ms, bound


def _wavefront_fns(dev, scene_name, size, origin_xy=(0, 0), patch_shape=None,
                   direct_light=False, **cfg_kw):
    """(kernel, plain, scene, cfg, params, corners) of the wavefront recorder
    over the primary planes of one sample (sample 0) of a patch: the
    wrapper on CUDA tensors and `record_wavefront_plain` on the same
    planes; `plain` takes an optional work dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import (
        record_wavefront_plain, trace_record_wavefront)
    from raymarchrenderer_tpu_torch.render.integrator import spp_rays
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = getattr(builtin, scene_name)()
    params = scene.init_params(dev)
    cfg = _train_cfg(size, **cfg_kw)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    px, py, sample, eye, d = spp_rays(cfg, corners, origin_xy,
                                      patch_shape or (size, size), 0, 1)

    def kernel():
        return trace_record_wavefront(scene, params, cfg, eye, d, px, py,
                                      sample, direct_light=direct_light)

    def plain(work=None):
        return record_wavefront_plain(scene, params, cfg, eye, d, px, py,
                                      sample, direct_light=direct_light,
                                      work=work)

    return kernel, plain, scene, cfg, params, corners


# the wavefront recorder against the mega recorder on the same rays
# (tests/test_diff.py:481-497): decisions and visibility off on fewer than
# 5e-3 of the entries, both-hit t within 5e-3 at bounce 0 and off by more
# than 1e-5 on fewer than 1e-3 of the later bounces' entries
WAVE_MEGA_FRAC = 5e-3
WAVE_MEGA_T = 5e-3


def parity_wavefront(dev, card):
    """The wavefront recorder: the train launch's bounce-0 planes
    (sphere_on_floor, 1024^2, 1 sample per lane, 4 bounces: the main
    launch) and csg_demo with NEE and roulette on the same planes (the NEE
    launch), each timed with its bound and the chain occupancy of its
    schedules (`wavefront_occupancy` on 32-ray warps); then csg_demo with
    NEE and roulette on a 256^2 patch, and there against the mega
    recorder (kernel #5) on the same rays.  Returns (max err, ms, plain
    ms, bound) of the main launch and {max_abs_err, ms, plain_ms,
    bound_ms, bound_by} of the NEE one."""
    from raymarchrenderer_tpu_torch.kernels.record import trace_record_fused
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers)

    def launch(name, label, scene_name, **kw):
        kernel, plain, scene, cfg, params, _ = _wavefront_fns(
            dev, scene_name, 1024, **kw)
        label = (f"{label}, {scene_name} 1024x1024 bounce-0 planes, 1 "
                 f"sample, {cfg.max_bounces} bounces")
        max_err, ms, plain_ms, work = _main_launch(
            label, kernel, plain, card, _planes_compare,
            work={"lane_steps": []})
        wavefront_occupancy(label, work.pop("lane_steps"),
                            "wavefront_paths", _ray_warps)
        prog, data, _ = paths_buffers(scene, params, dev)
        n = 1024 * 1024
        lights = scene.n_lights if kw.get("direct_light") else 0
        bound = _bound(scene, cfg, work, 36 * n + _buffer_bytes(prog, data),
                       (12 + 4 * lights) * cfg.max_bounces * n, lookups=0)
        PARITY_BOUNDS[name] = bound[:2]
        return max_err, ms, plain_ms, bound

    main = launch("record_wavefront", "wavefront recorder", "sphere_on_floor")
    nee = launch("record_wavefront_nee", "wavefront recorder + NEE + RR",
                 "csg_demo", direct_light=True, rr_start_bounce=1)
    max_err = max(main[0], nee[0])
    kernel, plain, scene, cfg, params, corners = _wavefront_fns(
        dev, "csg_demo", 1024, _NEE_PATCH, (256, 256), direct_light=True,
        rr_start_bounce=1)
    wave = kernel()
    max_err = max(max_err, _planes_compare(
        f"wavefront recorder + NEE + RR, csg_demo 256x256 patch at "
        f"{_NEE_PATCH}", wave, plain()))
    mega = trace_record_fused(scene, params, cfg, corners, _NEE_PATCH,
                              (256, 256), 0, n_samples=1, direct_light=True)
    torch.cuda.synchronize()
    hit = (wave["hit"] > 0) & (mega["hit"] > 0)
    dt = torch.where(hit, (wave["t"] - mega["t"]).abs(), 0.0)
    dec = float(((wave["mid"] != mega["mid"])
                 | (wave["hit"] != mega["hit"])).float().mean())
    sd = float((wave["sd"] != mega["sd"]).float().mean())
    later = float((dt[1:] > PIX_TOL).sum()) / max(int(hit[1:].sum()), 1)
    print(f"parity, wavefront vs mega recorder (kernel #4 vs #5), csg_demo "
          f"256x256 + NEE + RR: decisions off {dec:.3e}, sd off {sd:.3e} "
          f"(bars {WAVE_MEGA_FRAC:g}); bounce-0 max |dt| "
          f"{float(dt[0].max()):.3e} (bar {WAVE_MEGA_T:g}); later t off by "
          f"> {PIX_TOL:g} {later:.3e} (bar {MAX_FRAC_OFF:g}), max "
          f"{float(dt.max()):.3e}", flush=True)
    if not (int(hit.sum()) > 0 and dec < WAVE_MEGA_FRAC
            and sd < WAVE_MEGA_FRAC and float(dt[0].max()) < WAVE_MEGA_T
            and later < MAX_FRAC_OFF):
        raise AssertionError("the wavefront and mega recorders disagree")
    return (max_err, *main[1:], dict(
        max_abs_err=nee[0], ms=nee[1], plain_ms=nee[2], bound_ms=nee[3][0],
        bound_by=nee[3][1]))


def parity_spectral_grads(dev, card):
    """One spectral train step's loss and gradients (scene leaves and band
    rows) at 256^2, 2 samples, replayed over the spectral recorder's banks
    and over its plain version's."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import (
        record_spectral_plain, trace_record_fused_spectral)
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        train_grads_spectral_sharded)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    cfg = _train_cfg(256)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    target = torch.from_numpy(np.random.RandomState(3).uniform(
        0.0, 0.3, (256, 256, 3)).astype(np.float32)).to(dev)
    results = []
    for f in (trace_record_fused_spectral, record_spectral_plain):
        banks = f(scene, params, mats, cfg, corners, (0, 0), (256, 256), 0,
                  n_samples=2)
        loss, grads, bands = train_grads_spectral_sharded(
            scene, params, mats, cfg, corners, target, 2,
            march_impl="recorded", recorded=banks)
        if not all(float(b.abs().sum()) > 0.0 for b in bands):
            raise AssertionError("a band row's gradient vanished")
        results.append((loss, (grads, bands)))
    _grads_compare("spectral train step 256x256, 2 samples: kernel banks "
                   "vs plain banks (scene leaves and band rows)", *results)


def _write_target(path, dev, scene_name, size, direct_light, leaf,
                  factor=1.05):
    """The port's own render of the scene with the parameter `leaf(params)`
    (a radius) scaled by `factor`, 64 samples, saved as .npy."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.march import render_fused
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = getattr(builtin, scene_name)()
    params = scene.init_params(dev)
    leaf(params).mul_(factor)
    img = render_fused(scene, params, _train_cfg(size),
                       Camera(aspect=1.0).corner_rays_flat(dev), 0,
                       n_samples=64, direct_light=direct_light)
    np.save(path, img.cpu().numpy())


def _write_spectral_target(path, dev, size):
    """The port's own spectral render of spectral_demo with the sphere
    row's band ending at 620 nm instead of 590, 64 samples, saved as
    .npy."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.march import render_fused_spectral
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    mats.max_wave[2] = 620.0
    img = render_fused_spectral(scene, params, mats, _train_cfg(size),
                                Camera(aspect=1.0).corner_rays_flat(dev), 0,
                                n_samples=64)
    np.save(path, img.cpu().numpy())


def train_path(label, argv, dev, card, write_target, check_leaf,
               launches_expected):
    """One `train` run through the CLI toward the target `write_target(path)`
    writes; `check_leaf(tree)` picks the leaf whose gradient must not
    vanish (None: none); `launches_expected` maps each kernel to the
    launches the run must make (None: at least one).  With `--spectral`
    the band rows' gradients must not vanish, the fitted rows stay inside
    [380, 830] nm and the npz holds them.  Returns the launches."""
    from raymarchrenderer_tpu_torch.app import cli
    from raymarchrenderer_tpu_torch.scene import param_leaves

    spectral = "--spectral" in argv
    with tempfile.TemporaryDirectory() as tmp:
        target = os.path.join(tmp, "target.npy")
        write_target(target)
        out = os.path.join(tmp, "fit.npz")
        args = cli.build_parser().parse_args(
            argv + ["--target", target, "--out", out])
        for kernel in launches_expected:
            kernel.launches = 0
        t0 = time.perf_counter()
        if spectral:
            loss, params, mats, (grads, band_grads), img = cli.cmd_train(args)
        else:
            loss, params, grads, img = cli.cmd_train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: k.launches for k in launches_expected}
        for kernel, want in launches_expected.items():
            got = launches[kernel]
            if (got < 1) if want is None else (got != want):
                raise AssertionError(
                    f"{label}: {got} launches of {kernel.entry}, expected "
                    f"{'at least 1' if want is None else want}")
        if not (os.path.getsize(out) and os.path.getsize(
                os.path.join(tmp, "fit.png"))):
            raise AssertionError(f"{label}: the npz or the PNG is empty")
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{label}: the loss is not finite")
        if not all(bool(torch.isfinite(g).all())
                   for g in param_leaves(grads)):
            raise AssertionError(f"{label}: a gradient is not finite")
        moved = (float(check_leaf(grads).abs().max())
                 if check_leaf is not None else float("nan"))
        if check_leaf is not None and not moved > 0.0:
            raise AssertionError(f"{label}: the gradient that must not "
                                 "vanish is zero")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: the final render is not finite")
        bands = ""
        if spectral:
            if not all(bool(torch.isfinite(g).all())
                       and float(g.abs().max()) > 0.0 for g in band_grads):
                raise AssertionError(f"{label}: a band row's gradient is "
                                     "zero or not finite")
            rows = torch.stack(list(mats[:2]))
            if not bool(((rows >= 380.0) & (rows <= 830.0)).all()):
                raise AssertionError(f"{label}: a band left [380, 830] nm")
            with np.load(out) as z:
                if not {"band_min_wave", "band_max_wave",
                        "band_power", "leaf0"} <= set(z.files):
                    raise AssertionError(f"{label}: npz keys {z.files}")
            bands = (f", bands min {mats.min_wave.tolist()} max "
                     f"{mats.max_wave.tolist()} power "
                     f"{[round(x, 4) for x in mats.power.tolist()]}")
    print(f"main path, {label}: final loss {float(loss):.6f}, max |grad| of "
          f"the checked leaf {moved:.4e}{bands}, wall with target render, "
          f"steps, final render and files {wall:.3f} s, launches "
          f"{ {k.entry: v for k, v in launches.items()} } [{card}]",
          flush=True)
    return launches


def _mean_spread(xs):
    return {"mean": sum(xs) / len(xs), "min": min(xs), "max": max(xs)}


class MarchLog:
    """The `march_fused` launches made while the log is open: each
    launch's plane shape, active lanes and CUDA-event time, through the
    wrapper's `_launch_march_fused` (wrapped while open; the events add
    nothing to a launch).  With `keep`, `planes` gathers each launch's
    arguments (scene, params, cfg, o, d, dist_mult, active, t_max), its
    tensors detached copies."""

    def __init__(self, keep=False):
        self.keep = keep

    def __enter__(self):
        from raymarchrenderer_tpu_torch.kernels import march
        self.calls, self.planes = [], []
        self._orig = orig = march._launch_march_fused

        def copy(x):
            return x.detach().clone() if isinstance(x, torch.Tensor) else x

        def logged(scene, params, cfg, o, d, dist_mult, active, t_max):
            if self.keep:
                self.planes.append((scene, params, cfg, type(o)(*map(copy, o)),
                                    type(d)(*map(copy, d)), copy(dist_mult),
                                    copy(active), copy(t_max)))
            shape = tuple(torch.broadcast_shapes(*(c.shape
                                                   for c in (*o, *d))))
            act = torch.as_tensor(active, device=o.x.device).expand(shape)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(scene, params, cfg, o, d, dist_mult, active, t_max)
            end.record()
            self.calls.append((shape, act.sum(), start, end))
            return out

        march._launch_march_fused = logged
        return self

    def __exit__(self, *exc):
        from raymarchrenderer_tpu_torch.kernels import march
        march._launch_march_fused = self._orig

    def readings(self):
        torch.cuda.synchronize()
        return [{"shape": list(shape), "active": int(n),
                 "ms": start.elapsed_time(end)}
                for shape, n, start, end in self.calls]


def fused_train_path(dev, card, target, check_leaf):
    """`train --impl fused` at the train bench configuration (1024^2, 4
    spp, 4 bounces, 3 steps): `march_fused` must launch once per march
    (each call of its wrapper one launch); prints the launches per step
    and each launch's plane, active lanes and ms.  Returns the
    launches."""
    from raymarchrenderer_tpu_torch.kernels import march
    steps = int(TRAIN_FUSED_ARGV[TRAIN_FUSED_ARGV.index("--steps") + 1])
    with MarchLog() as log:
        launches = train_path(
            "train sphere_on_floor 1024x1024 --impl fused", TRAIN_FUSED_ARGV,
            dev, card, target, check_leaf,
            {march.MARCH_FUSED: None, march.MEGA_PATHS: None})[
                march.MARCH_FUSED]
    calls = log.readings()
    if len(calls) != launches:
        raise AssertionError(f"train --impl fused: {len(calls)} marches, "
                             f"{launches} march_fused launches")
    res = {"card": card, "launches": launches,
           "launches_per_step": launches / steps,
           "ms_per_step": sum(c["ms"] for c in calls) / steps,
           "calls": calls}
    print("train --impl fused launches: " + json.dumps(res), flush=True)
    _log_json("train_fused_launches", res)
    return launches


def fused_train_perf(dev, card):
    """The `train --impl fused` step at the train bench configuration, 3
    repetitions (host clock around synchronised work): the whole step and
    the `march_fused` launches inside it, their count, planes, active
    lanes and CUDA-event times.  One `train perf (fused):` JSON line."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        sgd, train_grads_sharded)
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    cfg = _train_cfg(1024)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    target = torch.full((1024, 1024, 3), 0.2, device=dev)
    args = (scene, params, cfg, corners, target, TRAIN_SPP)
    step, march_ms, launches = [], [], []
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        with MarchLog() as log:
            t0 = time.perf_counter()
            sgd(params, train_grads_sharded(*args, march_impl="fused")[1],
                1e-2)
            torch.cuda.synchronize()
            step.append((time.perf_counter() - t0) * 1e3)
        calls = log.readings()
        launches.append(len(calls))
        march_ms.append(sum(c["ms"] for c in calls))
    res = {"card": card, "config": "sphere_on_floor 1024x1024, 4 spp, 4 "
           "bounces, relax 1.9, 4 taps, --impl fused, remat",
           "step_ms": _mean_spread(step),
           "march_fused_launches_per_step": launches,
           "march_fused_ms_per_step": _mean_spread(march_ms),
           "last_step_launches": calls}
    print("train perf (fused): " + json.dumps(res), flush=True)
    return res


def train_perf(dev, card):
    """The train step at the full configuration, 3 repetitions: the
    recorder alone, the replay's forward (loss, no graph), the whole step
    (record, replay, backward, SGD), host clock around synchronised work;
    then one step's peak memory with and without remat."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import trace_record_fused
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        sgd, train_grads_sharded, train_loss_sharded)
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    cfg = _train_cfg(1024)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    target = torch.full((1024, 1024, 3), 0.2, device=dev)
    args = (scene, params, cfg, corners, target, TRAIN_SPP)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    record, forward, step = [], [], []
    for _ in range(3):
        banks, ms = timed(lambda: trace_record_fused(
            scene, params, cfg, corners, (0, 0), (1024, 1024), 0,
            n_samples=TRAIN_SPP))
        record.append(ms)
        forward.append(timed(lambda: train_loss_sharded(
            *args, march_impl="recorded", recorded=banks))[1])
        del banks
        step.append(timed(lambda: sgd(params, train_grads_sharded(
            *args, march_impl="recorded")[1], 1e-2))[1])
    memory = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        timed(lambda: train_grads_sharded(*args, march_impl="recorded",
                                          remat=remat))
        memory[f"peak_gb_remat_{'on' if remat else 'off'}"] = (
            torch.cuda.max_memory_allocated(dev) / 1e9)
    res = {"card": card, "config": "sphere_on_floor 1024x1024, 4 spp, 4 "
           "bounces, relax 1.9, 4 taps, recorded, remat",
           "record_ms": _mean_spread(record),
           "replay_forward_ms": _mean_spread(forward),
           "step_ms": _mean_spread(step),
           "backward_update_ms_derived": (sum(step) - sum(record)
                                          - sum(forward)) / len(step),
           "step_mpix_spp_per_s": 1024 * 1024 * TRAIN_SPP / 1e3 / (
               sum(step) / len(step)), **memory}
    print("train perf: " + json.dumps(res), flush=True)


def spectral_train_perf(dev, card):
    """The spectral train step at the full configuration, 3 repetitions:
    the spectral recorder alone, the replay's forward (loss, no graph),
    the whole step (record, replay, backward, band and SGD update), host
    clock around synchronised work; then one step's peak memory (the
    spectral step has no remat)."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import (
        trace_record_fused_spectral)
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        spectral_update, train_grads_spectral_sharded,
        train_loss_spectral_sharded)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    cfg = _train_cfg(1024)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    target = torch.full((1024, 1024, 3), 0.1, device=dev)
    args = (scene, params, mats, cfg, corners, target, TRAIN_SPP)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def step():
        _, grads, bands = train_grads_spectral_sharded(
            *args, march_impl="recorded")
        return spectral_update(params, mats, grads, bands, 1e-2)

    record, forward, whole = [], [], []
    for _ in range(3):
        banks, ms = timed(lambda: trace_record_fused_spectral(
            scene, params, mats, cfg, corners, (0, 0), (1024, 1024), 0,
            n_samples=TRAIN_SPP))
        record.append(ms)
        forward.append(timed(lambda: train_loss_spectral_sharded(
            *args, march_impl="recorded", recorded=banks))[1])
        del banks
        whole.append(timed(step)[1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timed(step)
    res = {"card": card, "config": "spectral_demo 1024x1024, 4 spp, 4 "
           "bounces, relax 1.9, 4 taps, recorded, soft edge 8 nm",
           "record_ms": _mean_spread(record),
           "replay_forward_ms": _mean_spread(forward),
           "step_ms": _mean_spread(whole),
           "backward_update_ms_derived": (sum(whole) - sum(record)
                                          - sum(forward)) / len(whole),
           "step_mpix_spp_per_s": 1024 * 1024 * TRAIN_SPP / 1e3 / (
               sum(whole) / len(whole)),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print("spectral train perf: " + json.dumps(res), flush=True)


def wavefront_path(dev, card):
    """The wavefront recorder through its entry point: no CLI verb reaches
    it (in the JAX package only tests do), so its path is one call of
    `trace_record_wavefront` on the train launch's primary planes
    (sphere_on_floor, 1024^2, 1 sample, 4 bounces), the counter zeroed
    just before and read just after.  Returns the launches."""
    from raymarchrenderer_tpu_torch.kernels import march
    kernel, *_ = _wavefront_fns(dev, "sphere_on_floor", 1024)
    march.RECORD_WAVEFRONT.launches = 0
    rec = kernel()
    torch.cuda.synchronize()
    launches = march.RECORD_WAVEFRONT.launches
    if launches != 1:
        raise AssertionError(f"wavefront path: {launches} launches")
    if not (bool(torch.isfinite(rec["t"]).all())
            and int(rec["hit"].sum()) > 0):
        raise AssertionError("wavefront path: no finite hits")
    print(f"main path, wavefront recorder (trace_record_wavefront, "
          f"sphere_on_floor 1024x1024 primary planes): {launches} launch, "
          f"{int(rec['hit'].sum())} banked hits [{card}]", flush=True)
    return launches


MAIN_RATES = {}      # label -> Mpix*spp/s of each main path's render


def main_path(label, argv, kernel, card):
    """One main path through the CLI; returns the kernel's launches."""
    from raymarchrenderer_tpu_torch.app import cli

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "main_path.png")
        args = cli.build_parser().parse_args(argv + ["--out", out])
        kernel.launches = 0
        t0 = time.perf_counter()
        img, n, render_s = cli.cmd_render(args)
        wall = time.perf_counter() - t0
        launches = kernel.launches
        if launches < 1:
            raise AssertionError(f"{label}: the main path launched no "
                                 f"{kernel.source.name} kernel")
        if not os.path.getsize(out):
            raise AssertionError(f"{label}: no PNG written")
        if tuple(img.shape) != (1024, 1024, 3):
            raise AssertionError(f"{label}: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: the image has non-finite values")
        mean = float(img.mean())
        _digest(f"main path: {label}", img)
        if not mean > 0.0:
            raise AssertionError(f"{label}: the image is black")
    rate = 1024 * 1024 * n / 1e6 / render_s
    MAIN_RATES[label] = rate
    print(f"main path, {label}: 1024x1024 @ {n:.0f} spp, render "
          f"{render_s:.3f} s ({rate:.2f} Mpix*spp/s), wall with scene setup "
          f"and PNG {wall:.3f} s, {launches} launch(es), image mean "
          f"{mean:.6f} [{card}]", flush=True)
    return launches


def perf(dev, card):
    """Kernels and plain versions at 1024^2 with 8 samples per launch (the
    CLI's default chunk); at 128 samples every kernel is timed alone in
    `kernel_times`."""
    res = {"card": card}
    for name, fns in (("rgb", lambda n: _paths_fns(dev, "sphere_on_floor",
                                                   n)[:2]),
                      ("spectral", lambda n: _spectral_fns(dev, n)[:2])):
        kernel, plain = fns(8)
        res[f"{name}_kernel_ms_n8"] = _cuda_ms(kernel, reps=3)
        res[f"{name}_plain_ms_n8"] = _cuda_ms(plain, reps=1, warmup=False)
    for key in [k for k in res if k.endswith("_ms_n8")]:
        res[key.replace("_ms_n8", "_mpix_spp_per_s_n8")] = (
            1024 * 1024 * 8 / 1e3 / res[key])
    print("perf: " + json.dumps(res), flush=True)


# ---- env-map and SH skies, wavefront modes --------------------------------

ENV_SCENE = os.path.join(_ROOT, "data", "scenes", "default.scene")
_ENV_PATCH = (320, 384)       # (x, y) of the 256^2 csg NEE env patch
_WAVE_PATCH = (384, 384)      # (x, y) of the SH and wavefront patches
_WAVE_SIZE = 128              # side of the wavefront parity patches: their
#                               plain versions march sample by sample
_WAVE_SPP = 3                 # prime samples of the wavefront patches
_WAVE_ENV_SPP = 11            # env wavefront: 8 slots, then 3 of 8 valid
_WAVE_MAIN_SPP = 8            # samples of the wavefront main paths' launch
_PRIME_SPP = 11               # dispersion env patch: 30 + 3 paths


def gradient_env():
    """bench.py:92-96's 512 x 1024 equirect sky (`app.bench.gradient_env`):
    a vertical gradient from (0.3, 0.5, 1.0) at the top to (1.0, 0.6,
    0.2) at the bottom."""
    from raymarchrenderer_tpu_torch.app.bench import gradient_env as sky
    return sky()


def _env_scene(env_gather="exact", image=None, name=None):
    """default.scene (or the builtin `name`, rebuilt as JSON) under an env
    image (the gradient sky by default)."""
    from raymarchrenderer_tpu_torch.scene import builtin, load_scene
    img = gradient_env() if image is None else image
    if name is None:
        return load_scene(ENV_SCENE, env_image=img, env_gather=env_gather)
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.5, 0.4])
    g = b.glossy([0.9, 0.9, 0.9], 0.1)
    b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.sphere(g, [2.2, 0.7, 0.5], 0.7)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    b.light([3, 7, -3], 60.0, 0.8)
    return b.build(env_image=img, env_gather=env_gather)


def _uv_compare(label, got, want):
    """The packed (u, v) banks of the kernel against the plain version's
    on the live slots (thr > 0 in the plain banks): equal on all but 1e-3
    and never more than one bin apart."""
    _digest("uv: " + label, got[3])
    live = (want[0] + want[1] + want[2]) > 0
    du = ((want[3] >> 16) - (got[3] >> 16)).abs()
    dv = ((want[3] & 0xFFFF) - (got[3] & 0xFFFF)).abs()
    off = float((((du > 0) | (dv > 0)) & live).sum()) / max(
        int(live.sum()), 1)
    bins = int(torch.where(live, torch.maximum(du, dv), 0).max())
    print(f"parity, {label}: {int(live.sum())} live slots, (u, v) off "
          f"{off:.3e} (bar {MAX_FRAC_OFF:g}), largest {bins} bin(s) (bar 1)",
          flush=True)
    if not (int(live.sum()) > 0 and off < MAX_FRAC_OFF and bins <= 1):
        raise AssertionError(f"the (u, v) banks disagree ({label})")


def _env_compare(label, got, want):
    """An env image's composite, kernel against plain: fewer than 1e-3 of
    the values off by more than 1e-3 (the JAX package's env bar,
    tests/test_kernels.py:109-123); returns the max abs error."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    frac3 = float((diff > 1e-3).float().mean())
    max_err = float(diff.max())
    print(f"parity, {label}: fraction off by > 1e-3 {frac3:.3e} (env bar "
          f"{MAX_FRAC_OFF:g}), max abs err {max_err:.3e}, kernel mean "
          f"{float(got.mean()):.6f}, plain mean {float(want.mean()):.6f}",
          flush=True)
    if not (bool(torch.isfinite(got).all()) and frac3 < MAX_FRAC_OFF
            and tuple(got.shape) == tuple(want.shape)):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({label})")
    return max_err


def _with_plain_launches(fn):
    """fn() with the deferred and wavefront entries' launches replaced by
    their plain versions (the chunking and the composite unchanged)."""
    from raymarchrenderer_tpu_torch.kernels import march
    saved = march._launch_mega_defer, march._launch_wavefront_paths
    march._launch_mega_defer = march._mega_defer_plain
    march._launch_wavefront_paths = march.wavefront_paths_plain
    try:
        return fn()
    finally:
        march._launch_mega_defer, march._launch_wavefront_paths = saved


def _defer_fns(dev, n, **cfg_kw):
    """(kernel, plain, scene, cfg, params) of the deferred-sky entry at the
    env main path's launch shape: default.scene under the gradient sky,
    1024^2, `n` paths from path 0; each returns (raw sum, banks), `plain`
    takes an optional work dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_paths
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid

    scene = _env_scene()
    params = scene.init_params(dev)
    cfg = _main_cfg(**cfg_kw)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    args = (scene, params, cfg, corners, (0, 0), 1024, 1024, 0, n, False)

    def kernel():
        return march._launch_mega_defer(*args, **_knobs())

    def plain(work=None):
        if work is None:
            return march._mega_defer_plain(*args, **_knobs())
        px, py = pixel_grid(1024, 1024, dev, (0, 0))
        c, banks = trace_mega_paths(scene, params, cfg, corners, px, py, 0,
                                    n_samples=n, defer_sky=True, work=work,
                                    **_knobs())
        return c.stack(-1), list(banks)

    return kernel, plain, scene, cfg, params


def parity_defer(dev, card):
    """The deferred-sky megakernel: the env main path's own launch
    (default.scene under the gradient sky, 1024^2, 32 paths): the raw sum,
    the banks and the composite image; then csg with NEE under a random
    env image on a 256^2 patch at a non-zero origin, with the exact and
    the "mxu" composite; then dispersion, NEE and roulette on a 128^2
    patch, 11 samples (a chunk of 30 paths and a tail launch of 3).
    Returns (max err, ms, plain ms, bound)."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers)

    kernel, plain, scene, cfg, params = _defer_fns(dev, 32)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)

    def compare(label, got, want):
        err = _compare(label + ", raw sum", got[0], want[0])
        for j, c in enumerate("rgb"):
            err = max(err, _compare(f"{label}, thr_{c} bank", got[1][j],
                                    want[1][j]))
        _uv_compare(label, got[1], want[1])
        return max(err, _env_compare(
            label + ", composite image",
            march.composite_uv(scene, params, *got),
            march.composite_uv(scene, params, *want)))

    max_err, ms, plain_ms, work = _main_launch(
        "RGB deferred sky, default.scene + gradient env 1024x1024, 32 "
        "paths (the env main path's launch)", kernel, plain, card, compare)
    occupancy("deferred main launch", work, _knobs()["march_unroll"],
              "mega_paths")
    out = kernel()
    comp_ms = _cuda_ms(lambda: march.composite_uv(scene, params, *out),
                       reps=3)
    del out
    print(f"composite (exact, 32 x 1024^2 lookups): {comp_ms:.3f} ms "
          f"[{card}]", flush=True)
    prog, data, _ = paths_buffers(scene, params, dev)
    bound = _bound(scene, cfg, work, 15 * 4 + _buffer_bytes(prog, data),
                   1024 * 1024 * (12 + 16 * 32))

    img = np.random.RandomState(5).uniform(0.0, 2.0, (64, 128, 3)).astype(
        np.float32)
    for gather in ("exact", "mxu"):
        nscene = _env_scene(gather, img, name="csg")
        nparams = nscene.init_params(dev)
        ncfg = _main_cfg()
        nargs = (nscene, nparams, ncfg, corners, _ENV_PATCH, 256, 256, 0, 8,
                 True)
        got = march._launch_mega_defer(*nargs, **_knobs())
        want = march._mega_defer_plain(*nargs, **_knobs())
        label = (f"RGB deferred sky + NEE, two-sphere scene 256x256 patch at "
                 f"{_ENV_PATCH}, 8 spp, {gather} composite")
        max_err = max(max_err, _compare(label + ", raw sum", got[0], want[0],
                                        nee=True))
        _uv_compare(label, got[1], want[1])
        max_err = max(max_err, _env_compare(
            label, march.composite_uv(nscene, nparams, *got),
            march.composite_uv(nscene, nparams, *want)))
    dscene = _env_scene("exact", img, name="csg")
    dparams = dscene.init_params(dev)
    dcfg = _main_cfg(separate_channels=True, rr_start_bounce=1)

    def render():
        return march.render_fused_patch(
            dscene, dparams, dcfg, corners, _DISP_PATCH, (128, 128), 0,
            n_samples=_PRIME_SPP, direct_light=True, **_knobs())

    launches = march.MEGA_PATHS_DEFER.launches
    got = render()
    torch.cuda.synchronize()
    n_launch = march.MEGA_PATHS_DEFER.launches - launches
    if n_launch != 2:
        raise AssertionError(f"{_PRIME_SPP} samples with dispersion: "
                             f"{n_launch} launches, expected 2")
    max_err = max(max_err, _env_compare(
        f"RGB deferred sky + dispersion + NEE + RR, 128x128 patch at "
        f"{_DISP_PATCH}, {_PRIME_SPP} spp (a chunk of 30 paths and a tail "
        f"of 3)", got, _with_plain_launches(render)))
    return max_err, ms, plain_ms, bound


def parity_sh(dev, card, sh_scene_path):
    """The SH sky in the RGB megakernel: a 256^2 patch of the SH scene,
    16 samples, against trace_mega_paths."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_paths
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.scene import load_scene

    scene = load_scene(sh_scene_path)
    params = scene.init_params(dev)
    cfg = _main_cfg()
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    got = march.render_fused_patch(scene, params, cfg, corners, _WAVE_PATCH,
                                   (256, 256), 0, n_samples=16, **_knobs())
    px, py = pixel_grid(256, 256, dev, _WAVE_PATCH)
    want = _mean(trace_mega_paths(scene, params, cfg, corners, px, py, 0,
                                  n_samples=16, **_knobs()), 16)
    return _compare(f"RGB SH sky, 256x256 patch at {_WAVE_PATCH}, 16 spp",
                    got, want)


def parity_wavefront_paths(dev, card):
    """The RGB wavefront entry at the full bounce budget: the main path's
    own launch (sphere_on_floor, 1024^2, 8 samples; timed, with its
    bound); csg with NEE, dispersion and roulette on a 128^2 patch, 3
    samples (prime); then default.scene under the gradient sky on a 128^2
    patch, 11 samples (a chunk of 8 path slots and one with n_valid 3 of
    8), through render_fused_patch against the same chunks on the plain
    version.  Returns (max err, ms, plain ms, bound)."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers)
    from raymarchrenderer_tpu_torch.scene import builtin

    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    cfg = _main_cfg()
    args = (scene, params, cfg, corners, (0, 0), 1024, 1024, 0,
            _WAVE_MAIN_SPP, False)
    label = (f"RGB wavefront, sphere_on_floor 1024x1024, {_WAVE_MAIN_SPP} "
             f"spp, {cfg.max_bounces} bounces (the wavefront main path's "
             "launch)")
    max_err, ms, plain_ms, work = _main_launch(
        label, lambda: march._launch_wavefront_paths(*args),
        lambda work=None: march.wavefront_paths_plain(*args, work=work),
        card, count_apart=False, work={"lane_steps": []})
    planes = work.pop("lane_steps")
    if planes:                  # a plain march that keeps per-lane steps
        wavefront_occupancy(label, planes, "wavefront_paths")
    prog, data, _ = paths_buffers(scene, params, dev)
    bound = _bound(scene, cfg, work, 15 * 4 + _buffer_bytes(prog, data),
                   1024 * 1024 * 12, lookups=0)
    n = _WAVE_SIZE
    nscene = builtin.csg_demo()
    nparams = nscene.init_params(dev)
    ncfg = _main_cfg(separate_channels=True, rr_start_bounce=1)
    nargs = (nscene, nparams, ncfg, corners, _WAVE_PATCH, n, n, 0,
             _WAVE_SPP, True)
    max_err = max(max_err, _compare(
        f"RGB wavefront + NEE + dispersion + RR, csg_demo {n}x{n} patch, "
        f"{_WAVE_SPP} spp, {ncfg.max_bounces} bounces",
        march._launch_wavefront_paths(*nargs),
        march.wavefront_paths_plain(*nargs), nee=True))
    escene = _env_scene()
    eparams = escene.init_params(dev)

    def render():
        return march.render_fused_patch(escene, eparams, cfg, corners,
                                        _WAVE_PATCH, (n, n), 0,
                                        n_samples=_WAVE_ENV_SPP,
                                        mode="wavefront")

    launches = march.WAVEFRONT_PATHS.launches
    got = render()
    torch.cuda.synchronize()
    if march.WAVEFRONT_PATHS.launches != launches + 2:
        raise AssertionError("the env wavefront render is not two launches")
    max_err = max(max_err, _env_compare(
        f"RGB wavefront, deferred sky, default.scene {n}x{n} patch, "
        f"{_WAVE_ENV_SPP} spp, {cfg.max_bounces} bounces (8 slots, then "
        f"n_valid 3 of 8)", got,
        _with_plain_launches(render)))
    return max_err, ms, plain_ms, bound


def parity_wavefront_spectral(dev, card):
    """The spectral wavefront entry at the full bounce budget against
    wavefront_spectral_plain: the main path's own launch (spectral_demo,
    1024^2, 8 samples; timed, with its bound, and the chain occupancy of
    the nested loops, of its lane machine and of the pixel queue from the
    plain version's per-lane steps), then a 128^2 patch at a non-zero
    origin, 3 samples.  Returns (max err, ms, plain ms, bound)."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        spectral_buffers)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    cfg = _main_cfg()
    corners = Camera(aspect=1.0).corner_rays_flat(dev)

    def fns(origin, size, spp):
        return (lambda: march.render_fused_spectral(
                    scene, params, mats, cfg, corners, 0, n_samples=spp,
                    origin_xy=origin, patch_shape=(size, size),
                    mode="wavefront"),
                lambda work=None: march.wavefront_spectral_plain(
                    scene, params, mats, cfg, corners, 0, spp, origin, size,
                    size, work=work))

    label = (f"spectral wavefront, 1024x1024, {_WAVE_MAIN_SPP} spp, "
             f"{cfg.max_bounces} bounces (the wavefront main path's launch)")
    max_err, ms, plain_ms, work = _main_launch(
        label, *fns((0, 0), 1024, _WAVE_MAIN_SPP), card, count_apart=False,
        work={"lane_steps": []})
    wavefront_occupancy(label, work.pop("lane_steps"), "wavefront_spectral")
    prog, data, _ = spectral_buffers(scene, params, mats, dev)
    bound = _bound(scene, cfg, work, 15 * 4 + _buffer_bytes(prog, data),
                   1024 * 1024 * 12, lookups=0)
    kernel, plain = fns(_SPEC_PATCH, _WAVE_SIZE, _WAVE_SPP)
    max_err = max(max_err, _compare(
        f"spectral wavefront, {_WAVE_SIZE}x{_WAVE_SIZE} patch at "
        f"{_SPEC_PATCH}, {_WAVE_SPP} spp, {cfg.max_bounces} bounces",
        kernel(), plain()))
    return max_err, ms, plain_ms, bound


def env_main_path(dev, card, sky_path, argv=ENV_ARGV, label="rgb --env-map",
                  perf="env perf"):
    """render --env-map at the full configuration through the CLI (`argv`):
    4 launches of the deferred-sky kernel and none of the constant-sky
    one; the kernel's and the composite's time by CUDA events around each
    call, and the rate.  Returns the deferred kernel's launches."""
    from raymarchrenderer_tpu_torch.app import cli
    from raymarchrenderer_tpu_torch.kernels import march

    timed = {"kernel": [], "composite": []}

    def timer(name, fn):
        def wrapped(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            timed[name].append((start, end))
            return out
        return wrapped

    saved = march._launch_mega_defer, march.composite_uv
    march._launch_mega_defer = timer("kernel", saved[0])
    march.composite_uv = timer("composite", saved[1])
    march.MEGA_PATHS.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "env.png")
            args = cli.build_parser().parse_args(argv + [
                "--env-map", sky_path, "--out", out])
            march.MEGA_PATHS_DEFER.launches = 0
            img, n, render_s = cli.cmd_render(args)
            launches = march.MEGA_PATHS_DEFER.launches
            const = march.MEGA_PATHS.launches
            if not os.path.getsize(out):
                raise AssertionError("env main path: no PNG written")
    finally:
        march._launch_mega_defer, march.composite_uv = saved
    torch.cuda.synchronize()
    if launches != 4 or const != 0:
        raise AssertionError(f"env main path: {launches} deferred and "
                             f"{const} constant-sky launches, expected 4, 0")
    if tuple(img.shape) != (1024, 1024, 3) or not bool(
            torch.isfinite(img).all()) or not float(img.mean()) > 0.0:
        raise AssertionError("env main path: the image is wrong")
    k_ms = sum(s.elapsed_time(e) for s, e in timed["kernel"])
    c_ms = sum(s.elapsed_time(e) for s, e in timed["composite"])
    rate = 1024 * 1024 * n / 1e6 / render_s
    print(f"main path, {label} default.scene: 1024x1024 @ {n:.0f} spp, "
          f"render {render_s:.3f} s ({rate:.2f} Mpix*spp/s), {launches} "
          f"deferred launches ({k_ms:.3f} ms of kernel), {len(timed['composite'])} "
          f"composites ({c_ms:.3f} ms), {const} constant-sky launches, "
          f"image mean {float(img.mean()):.6f} [{card}]", flush=True)
    print(f"{perf}: " + json.dumps({
        "card": card, "render_s": render_s, "mpix_spp_per_s": rate,
        "kernel_ms": k_ms, "composite_ms": c_ms,
        "kernel_ms_each": [s.elapsed_time(e) for s, e in timed["kernel"]],
        "composite_ms_each": [s.elapsed_time(e)
                              for s, e in timed["composite"]]}), flush=True)
    return launches


def write_sh_scene(path):
    """default.scene with an `environment.sh` sky: a DC term of 0.3 and
    seeded band-1..3 coefficients."""
    from raymarchrenderer_tpu_torch.core.sh import constant_coeffs
    sh = constant_coeffs(0.3)
    sh[1:] = np.random.RandomState(2).uniform(-0.1, 0.1, (15, 3))
    with open(ENV_SCENE) as f:
        doc = json.load(f)
    doc.setdefault("environment", {})["sh"] = sh.tolist()
    with open(path, "w") as f:
        json.dump(doc, f)


def _write_env_target(path, dev, size):
    """The port's render of default.scene under the gradient sky with the
    sphere's albedo scaled by 1.5, 64 samples, saved as .npy."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.march import render_fused

    scene = _env_scene()
    params = scene.init_params(dev)
    params["materials"][2][0].mul_(1.5)
    img = render_fused(scene, params, _train_cfg(size),
                       Camera(aspect=1.0).corner_rays_flat(dev), 0,
                       n_samples=64)
    np.save(path, img.cpu().numpy())


def _printed_losses(fn):
    """(fn(), the losses a `train` run inside it printed, step by step)."""
    import contextlib
    import io
    import re
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            sys.__stdout__.write(text)
            return buf.write(text)

    with contextlib.redirect_stdout(Tee()):
        out = fn()
    return out, [float(x) for x in re.findall(r"step +\d+ loss ([0-9.e+-]+)",
                                              buf.getvalue())]


def env_train_path(dev, card, sky_path):
    """train --env-map at 256^2 through the CLI: 3 recorder launches, the
    deferred kernel for the final render, the env image's gradient
    non-zero, and the printed loss falling from step 0 to step 2."""
    from raymarchrenderer_tpu_torch.kernels import march
    launches, losses = _printed_losses(lambda: train_path(
        "train --env-map default.scene 256x256 (recorded)",
        ENV_TRAIN_ARGV + ["--env-map", sky_path], dev, card,
        lambda p: _write_env_target(p, dev, 256),
        lambda tree: tree["env"]["image"],
        {march.RECORD_PATHS: 3, march.MEGA_PATHS_DEFER: None,
         march.MEGA_PATHS: 0}))
    if len(losses) != 3 or not losses[-1] < losses[0]:
        raise AssertionError(f"train --env-map: losses {losses} do not fall")
    print(f"main path, train --env-map: losses {losses} [{card}]", flush=True)
    return launches[march.RECORD_PATHS]


def exact_train_path(dev, card):
    """train --normal-taps 0 (the exact normal) through the CLI: csg_demo
    with NEE at 256^2 toward its render with the floor's albedo x 1.5: 3
    recorder launches (ExactNormal<Banks>), the render kernel for the
    final image, the smooth union's radius gradient non-zero (the normal
    enters NEE's cos term, so the replay differentiates the reverse
    sweep) and the printed loss falling.  Returns the recorder's
    launches."""
    from raymarchrenderer_tpu_torch.kernels import march

    def floor_albedo(tree):
        return tree["materials"][0][0]

    launches, losses = _printed_losses(lambda: train_path(
        "train --normal-taps 0 csg --direct-light 256x256 (recorded)",
        TRAIN_EXACT_ARGV, dev, card,
        lambda p: _write_target(p, dev, "csg_demo", 256, True,
                                floor_albedo, 1.5),
        lambda tree: tree["objects"][3][1],
        {march.RECORD_PATHS: 3, march.MEGA_PATHS: None}))
    if len(losses) != 3 or not losses[-1] < losses[0]:
        raise AssertionError(f"train --normal-taps 0: losses {losses} do "
                             "not fall")
    print(f"main path, train --normal-taps 0: losses {losses} [{card}]",
          flush=True)
    return launches[march.RECORD_PATHS]


def env_train_perf(dev, card):
    """The train --env-map step at its main path's size (256^2, 3
    repetitions) and at the RGB train path's (1024^2, 1), beside the same
    step on default.scene under its constant sky: the recorder, the
    replay's forward, the whole step (record, replay, backward, SGD), host
    clock around synchronised work.  The backward of the env scene less
    the constant sky's is what the env image's gradient costs (its
    gather's backward is a scatter-add into the texels)."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels.record import trace_record_fused
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        sgd, train_grads_sharded, train_loss_sharded)
    from raymarchrenderer_tpu_torch.scene import load_scene

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res = {"card": card, "config": "default.scene, 4 spp, 4 bounces, relax "
           "1.9, 4 taps, recorded, remat"}
    for size, reps in ((256, 3), (1024, 1)):
        for sky, scene in (("env", _env_scene()),
                           ("constant", load_scene(ENV_SCENE))):
            params = scene.init_params(dev)
            cfg = _train_cfg(size)
            corners = Camera(aspect=1.0).corner_rays_flat(dev)
            target = torch.full((size, size, 3), 0.3, device=dev)
            args = (scene, params, cfg, corners, target, TRAIN_SPP)
            record, forward, step = [], [], []
            for _ in range(reps):
                banks, ms = timed(lambda: trace_record_fused(
                    scene, params, cfg, corners, (0, 0), (size, size), 0,
                    n_samples=TRAIN_SPP))
                record.append(ms)
                forward.append(timed(lambda: train_loss_sharded(
                    *args, march_impl="recorded", recorded=banks))[1])
                del banks
                step.append(timed(lambda: sgd(params, train_grads_sharded(
                    *args, march_impl="recorded")[1], 1e-2))[1])
            res[f"{sky}_{size}"] = {
                "record_ms": _mean_spread(record),
                "replay_forward_ms": _mean_spread(forward),
                "step_ms": _mean_spread(step),
                "backward_update_ms_derived": (sum(step) - sum(record)
                                               - sum(forward)) / len(step)}
    print("env train perf: " + json.dumps(res), flush=True)


def wavefront_paths_path(dev, card):
    """The wavefront modes through the library API (no CLI verb picks
    them; "auto" is always mega, as in the JAX package): the RGB entry at
    1024^2, 8 samples, constant sky and then the gradient env (one launch,
    8 slots, and its composite), and the spectral entry at 1024^2, 8
    samples, each counter zeroed just before and read just after.
    Returns (RGB launches, spectral launches)."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    from raymarchrenderer_tpu_torch.scene import builtin

    cfg = _main_cfg()
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    n = _WAVE_MAIN_SPP
    rgb = 0
    for label, scene in (("sphere_on_floor", builtin.sphere_on_floor()),
                         ("default.scene + gradient env", _env_scene())):
        params = scene.init_params(dev)
        march.WAVEFRONT_PATHS.launches = 0
        t0 = time.perf_counter()
        img = march.render_fused(scene, params, cfg, corners, 0,
                                 n_samples=n, mode="wavefront")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = march.WAVEFRONT_PATHS.launches
        if launches != 1 or not bool(torch.isfinite(img).all()) or not \
                float(img.mean()) > 0.0:
            raise AssertionError(f"wavefront path ({label}): {launches} "
                                 "launches or a bad image")
        rgb += launches
        print(f"main path, RGB wavefront (render_fused mode=\"wavefront\", "
              f"{label}, 1024x1024, {n} spp): {launches} launch, {wall:.3f} s "
              f"with the composite, image mean {float(img.mean()):.6f} "
              f"[{card}]", flush=True)
    scene, params, mats = spectral_demo(dev)
    march.WAVEFRONT_SPECTRAL.launches = 0
    t0 = time.perf_counter()
    img = march.render_fused_spectral(scene, params, mats, cfg, corners, 0,
                                      n_samples=n, mode="wavefront")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spec = march.WAVEFRONT_SPECTRAL.launches
    if spec != 1 or not float(img.mean()) > 0.0:
        raise AssertionError(f"spectral wavefront path: {spec} launches")
    print(f"main path, spectral wavefront (render_fused_spectral mode="
          f"\"wavefront\", 1024x1024, {n} spp): {spec} launch, {wall:.3f} s, "
          f"image mean {float(img.mean()):.6f} [{card}]", flush=True)
    return rgb, spec

# ---- the exact normal (normal_taps = 0) -----------------------------------

_EXACT_SIZE = 128             # side of the exact-normal parity patches


def _exact_case(label, kernel, plain, compare, scene, cfg, in_bytes,
                out_bytes, card, lookups=1):
    """Kernel vs plain on one exact-normal patch: parity by `compare`, the
    plain version's time (one run, which also counts its work), the
    kernel's (mean of 3) and the bound.  Returns the `normal_taps_0` note
    of the kernel's entry."""
    got = kernel()
    work = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(work)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    max_err = compare(label, got, want)
    del got, want
    ms = _cuda_ms(kernel, reps=3, warmup=False)
    bound = _bound(scene, cfg, work, in_bytes, out_bytes, lookups)
    print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (counted "
          f"the work), bound {bound[0]:.4f} ms ({bound[1]}) [{card}]",
          flush=True)
    return {"patch": label, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]}


def parity_exact(dev, card, sh_scene_path):
    """Every shading kernel with `normal_taps=0` (the exact normal, each
    source's ExactNormal instantiation) against its plain version on a
    128^2 patch at a non-zero origin: the RGB render (csg with NEE,
    dispersion and roulette), its SH and deferred skies, the RGB (NEE and
    roulette) and spectral wavefront entries, the spectral render, and
    the three recorders.  Returns {entry name: its normal_taps_0 note}."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers, spectral_buffers)
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_paths
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.scene import builtin, load_scene

    n = _EXACT_SIZE
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    notes = {}

    def in_bytes(scene, params, mats=None):
        bufs = (paths_buffers(scene, params, dev) if mats is None
                else spectral_buffers(scene, params, mats, dev))
        return 15 * 4 + _buffer_bytes(*bufs[:2])

    def nee_compare(label, got, want):
        return _compare(label, got, want, nee=True)

    # kernel #2, constant sky: csg with NEE, dispersion and roulette
    kernel, plain, scene, cfg, params = _paths_fns(
        dev, "csg_demo", 4, _NEE_PATCH, (n, n), direct_light=True,
        separate_channels=True, rr_start_bounce=1, normal_taps=0)
    notes["mega_paths"] = _exact_case(
        f"exact normal, RGB + NEE + dispersion + RR, csg_demo {n}x{n} patch "
        f"at {_NEE_PATCH}, 4 spp", kernel, lambda w: plain(w), nee_compare,
        scene, cfg, in_bytes(scene, params), n * n * 12, card)
    # the SH sky
    sscene = load_scene(sh_scene_path)
    sparams = sscene.init_params(dev)
    scfg = _main_cfg(normal_taps=0)

    def sh_plain(work):
        px, py = pixel_grid(n, n, dev, _WAVE_PATCH)
        return _mean(trace_mega_paths(sscene, sparams, scfg, corners, px, py,
                                      0, n_samples=8, work=work, **_knobs()),
                     8)
    note = _exact_case(
        f"exact normal, RGB SH sky, {n}x{n} patch at {_WAVE_PATCH}, 8 spp",
        lambda: march.render_fused_patch(sscene, sparams, scfg, corners,
                                         _WAVE_PATCH, (n, n), 0, n_samples=8,
                                         **_knobs()),
        sh_plain, _compare, sscene, scfg, in_bytes(sscene, sparams),
        n * n * 12, card)
    notes["mega_paths"]["sh_sky"] = note
    # the deferred sky
    escene = _env_scene()
    eparams = escene.init_params(dev)
    ecfg = _main_cfg(normal_taps=0)
    eargs = (escene, eparams, ecfg, corners, _WAVE_PATCH, n, n, 0, 8, False)

    def defer_plain(work):
        px, py = pixel_grid(n, n, dev, _WAVE_PATCH)
        c, banks = trace_mega_paths(escene, eparams, ecfg, corners, px, py, 0,
                                    n_samples=8, defer_sky=True, work=work,
                                    **_knobs())
        return c.stack(-1), list(banks)

    def defer_compare(label, got, want):
        err = _compare(label + ", raw sum", got[0], want[0])
        for j, c in enumerate("rgb"):
            err = max(err, _compare(f"{label}, thr_{c} bank", got[1][j],
                                    want[1][j]))
        _uv_compare(label, got[1], want[1])
        return max(err, _env_compare(
            label + ", composite image",
            march.composite_uv(escene, eparams, *got),
            march.composite_uv(escene, eparams, *want)))

    notes["mega_paths_defer"] = _exact_case(
        f"exact normal, RGB deferred sky, default.scene + gradient env "
        f"{n}x{n} patch at {_WAVE_PATCH}, 8 paths",
        lambda: march._launch_mega_defer(*eargs, **_knobs()), defer_plain,
        defer_compare, escene, ecfg, in_bytes(escene, eparams),
        n * n * (12 + 16 * 8), card)
    # the RGB wavefront entry: csg with NEE and roulette (its plain
    # version marches sample by sample: dispersion would triple it)
    wscene = builtin.csg_demo()
    wparams = wscene.init_params(dev)
    wcfg = _main_cfg(rr_start_bounce=1, normal_taps=0)
    wargs = (wscene, wparams, wcfg, corners, _WAVE_PATCH, n, n, 0,
             _WAVE_SPP, True)
    notes["wavefront_paths"] = _exact_case(
        f"exact normal, RGB wavefront + NEE + RR, csg_demo "
        f"{n}x{n} patch at {_WAVE_PATCH}, {_WAVE_SPP} spp, "
        f"{wcfg.max_bounces} bounces",
        lambda: march._launch_wavefront_paths(*wargs),
        lambda w: march.wavefront_paths_plain(*wargs, work=w), nee_compare,
        wscene, wcfg, in_bytes(wscene, wparams), n * n * 12, card,
        lookups=0)
    # kernel #1: the spectral render and its wavefront entry
    kernel, plain, sscene2, sp_cfg, (spar, smats) = _spectral_fns(
        dev, 4, _SPEC_PATCH, (n, n), normal_taps=0)
    notes["mega_spectral"] = _exact_case(
        f"exact normal, spectral {n}x{n} patch at {_SPEC_PATCH}, 4 spp",
        kernel, lambda w: plain(w), _compare, sscene2, sp_cfg,
        in_bytes(sscene2, spar, smats), n * n * 12, card)
    notes["wavefront_spectral"] = _exact_case(
        f"exact normal, spectral wavefront {n}x{n} patch at {_SPEC_PATCH}, "
        f"{_WAVE_SPP} spp, {sp_cfg.max_bounces} bounces",
        lambda: march.render_fused_spectral(
            sscene2, spar, smats, sp_cfg, corners, 0, n_samples=_WAVE_SPP,
            origin_xy=_SPEC_PATCH, patch_shape=(n, n), mode="wavefront"),
        lambda w: march.wavefront_spectral_plain(
            sscene2, spar, smats, sp_cfg, corners, 0, _WAVE_SPP,
            _SPEC_PATCH, n, n, work=w),
        _compare, sscene2, sp_cfg, in_bytes(sscene2, spar, smats),
        n * n * 12, card, lookups=0)
    # the recorders (#5, #6, #4) at the train configuration
    kernel, plain, rscene, rcfg, rparams = _record_fns(
        dev, "csg_demo", 1024, 2, _NEE_PATCH, (n, n), direct_light=True,
        normal_taps=0)
    notes["record_paths"] = _exact_case(
        f"exact normal, recorder + NEE, csg_demo {n}x{n} patch at "
        f"{_NEE_PATCH}, 2 samples", kernel, lambda w: plain(w),
        _planes_compare, rscene, rcfg, in_bytes(rscene, rparams),
        n * n * (12 + 4 * rscene.n_lights) * 2 * rcfg.max_bounces, card)
    kernel, plain, qscene, qcfg, (qpar, qmats) = _record_spectral_fns(
        dev, 1024, 4, _SPEC_PATCH, (n, n), normal_taps=0)
    notes["record_spectral"] = _exact_case(
        f"exact normal, spectral recorder {n}x{n} patch at {_SPEC_PATCH}, "
        f"4 samples", kernel, lambda w: plain(w), _planes_compare, qscene,
        qcfg, in_bytes(qscene, qpar, qmats), n * n * 12 * 4 * 4, card)
    kernel, plain, vscene, vcfg, vparams, _ = _wavefront_fns(
        dev, "csg_demo", 1024, _NEE_PATCH, (n, n), direct_light=True,
        rr_start_bounce=1, normal_taps=0)
    notes["record_wavefront"] = _exact_case(
        f"exact normal, wavefront recorder + NEE + RR, csg_demo {n}x{n} "
        f"patch at {_NEE_PATCH}", kernel, lambda w: plain(w),
        _planes_compare, vscene, vcfg, 36 * n * n + in_bytes(vscene, vparams)
        - 15 * 4, n * n * (12 + 4 * vscene.n_lights) * vcfg.max_bounces,
        card, lookups=0)
    return notes


# ---- scene tables sized from the program -----------------------------------

_BIG_PATCH = (448, 448)       # (x, y) of the 128^2 sized-table patches


def parity_sized_tables(dev, card):
    """The scenes the card once refused, each kernel against its plain
    version on a 128^2 patch: a 40-node object (over the old 16-register
    cap; its stored slots need more than 48 KiB of shared memory) in the
    RGB megakernel with 4 taps and with the exact normal, in the spectral
    megakernel and in the recorder; 12 lights under NEE (over the old
    8-light table) in the RGB megakernel and the recorder.  Returns the
    largest image error."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from _torch_scenes import BIG_OBJECT_SCENE, many_lights_scene
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.record import (
        record_plain, trace_record_fused)
    from raymarchrenderer_tpu_torch.render.mega import (trace_mega_paths,
                                                        trace_mega_spectral)
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)
    from raymarchrenderer_tpu_torch.scene import loads_scene

    n, spp = 128, 4
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    px, py = pixel_grid(n, n, dev, _BIG_PATCH)
    max_err = 0.0
    for label, scene, nee in (
            ("40-node object", loads_scene(BIG_OBJECT_SCENE), False),
            ("12 lights + NEE", many_lights_scene(12), True)):
        params = scene.init_params(dev)
        for taps in ((4, 0) if not nee else (4,)):
            cfg = _main_cfg(normal_taps=taps)
            got = march.render_fused_patch(scene, params, cfg, corners,
                                           _BIG_PATCH, (n, n), 0,
                                           n_samples=spp, direct_light=nee,
                                           **_knobs())
            want = _mean(trace_mega_paths(
                scene, params, cfg, corners, px, py, 0, n_samples=spp,
                direct_light=nee, **_knobs()), spp)
            max_err = max(max_err, _compare(
                f"RGB, {label}, {n}x{n} patch at {_BIG_PATCH}, {spp} spp, "
                f"{taps} taps", got, want, nee=nee))
        rcfg = _train_cfg(1024)
        _planes_compare(
            f"recorder, {label}, {n}x{n} patch at {_BIG_PATCH}, 2 samples",
            trace_record_fused(scene, params, rcfg, corners, _BIG_PATCH,
                               (n, n), 0, n_samples=2, direct_light=nee),
            record_plain(scene, params, rcfg, corners, _BIG_PATCH, (n, n),
                         0, n_samples=2, direct_light=nee))
        if nee:
            continue
        mats = band_table(scene, dev)
        cfg = _main_cfg()
        got = march.render_fused_spectral(scene, params, mats, cfg, corners,
                                          0, n_samples=spp,
                                          origin_xy=_BIG_PATCH,
                                          patch_shape=(n, n), **_knobs())
        want = _mean(trace_mega_spectral(scene, params, mats, cfg, corners,
                                         px, py, 0, n_samples=spp,
                                         **_knobs()), spp)
        max_err = max(max_err, _compare(
            f"spectral, {label}, {n}x{n} patch at {_BIG_PATCH}, {spp} spp",
            got, want))
    print(f"sized tables: every kernel met its bar [{card}]", flush=True)
    return max_err


# ---- each kernel at its main launch, alone ---------------------------------

# the main launches whose plain version takes minutes at 128 samples: their
# bound counts the work of a 1024^2 run of 8 samples (8 paths) and scales it
_SCALED = ("mega_paths_csg_nee", "mega_paths_sh", "mega_paths_exact",
           "mega_spectral_exact", "mega_paths_defer_exact")


def _train_march_planes(dev):
    """Every `march_fused` call of one `train --impl fused` step at the
    train bench configuration (sphere_on_floor, 1024^2, 4 spp, 4 bounces,
    relax 1.9): [(scene, params, cfg, o, d, dist_mult, active, t_max)] as
    the wrapper got them, the planes detached."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        train_grads_sharded)
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    cfg = _train_cfg(1024)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    target = torch.full((1024, 1024, 3), 0.2, device=dev)
    with MarchLog(keep=True) as log:
        train_grads_sharded(scene, params, cfg, corners, target, TRAIN_SPP,
                            march_impl="fused")
    torch.cuda.synchronize()
    return log.planes


def _main_kernels(dev, sh_scene_path):
    """{name: (kernel, plain, n samples or paths, scene, cfg, buffers, out
    bytes)} of every kernel at its main path's launch; `plain(n, work)`
    runs the plain version at n samples (paths) from 0, counting `work`.
    "march_fused_step" is every `march_fused` launch of one `train --impl
    fused` step (8 planes of 4 * 1024 x 1024 rays); its bytes are the
    planes' (`_march_bytes`), in and out."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        object_buffers, paths_buffers, spectral_buffers)
    from raymarchrenderer_tpu_torch.render import integrator
    pix = 1024 * 1024
    res = {}

    def paths(name, scene_name, n=128, **kw):
        kernel, _, scene, cfg, params = _paths_fns(dev, scene_name, n, **kw)
        res[name] = (kernel,
                     lambda m, w: _paths_fns(dev, scene_name, m, **kw)[1](w),
                     n, scene, cfg, paths_buffers(scene, params, dev),
                     12 * pix)

    def spectral(name, **kw):
        kernel, _, scene, cfg, (params, mats) = _spectral_fns(dev, 128, **kw)
        res[name] = (kernel, lambda m, w: _spectral_fns(dev, m, **kw)[1](w),
                     128, scene, cfg,
                     spectral_buffers(scene, params, mats, dev), 12 * pix)

    def defer(name, **kw):
        kernel, _, scene, cfg, params = _defer_fns(dev, 32, **kw)
        res[name] = (kernel, lambda m, w: _defer_fns(dev, m, **kw)[1](w),
                     32, scene, cfg, paths_buffers(scene, params, dev),
                     pix * (12 + 16 * 32))

    paths("mega_paths", "sphere_on_floor")
    paths("mega_paths_csg_nee", "csg_demo", direct_light=True)
    paths("mega_paths_sh", sh_scene_path)
    defer("mega_paths_defer")
    spectral("mega_spectral")
    paths("mega_paths_exact", "sphere_on_floor", normal_taps=0)
    spectral("mega_spectral_exact", normal_taps=0)
    defer("mega_paths_defer_exact", normal_taps=0)
    kernel, _, scene, cfg, params = _record_fns(dev, "sphere_on_floor", 1024,
                                                TRAIN_SPP)
    res["record_paths"] = (kernel, None, TRAIN_SPP, scene, cfg, (), 0)
    kernel, _, scene, cfg, _ = _record_spectral_fns(dev, 1024, TRAIN_SPP)
    res["record_spectral"] = (kernel, None, TRAIN_SPP, scene, cfg, (), 0)
    for name, scene_name, kw in (
            ("record_wavefront", "sphere_on_floor", {}),
            ("record_wavefront_nee", "csg_demo",
             dict(direct_light=True, rr_start_bounce=1))):
        kernel, _, scene, cfg, *_ = _wavefront_fns(dev, scene_name, 1024,
                                                   **kw)
        res[name] = (kernel, None, 1, scene, cfg, (), 0)
    kernel, _, scene, cfg, params, _ = _march_fns(dev)
    res["march_fused"] = (kernel, None, TRAIN_SPP, scene, cfg,
                          object_buffers(scene, params, dev), 0)
    planes = _train_march_planes(dev)

    def step_plain(m, work):
        with torch.no_grad():
            return [integrator.march(*c[:7], t_max=c[7], work=work)
                    for c in planes]

    res["march_fused_step"] = (
        lambda: [march.march_fused(*c[:7], t_max=c[7]) for c in planes],
        step_plain, TRAIN_SPP, scene, cfg, object_buffers(scene, params, dev),
        sum(_march_bytes(*c[3:]) for c in planes))
    _, _, scene, cfg, params = _paths_fns(dev, "sphere_on_floor", 1)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    res["wavefront_paths"] = (
        lambda: march._launch_wavefront_paths(
            scene, params, cfg, corners, (0, 0), 1024, 1024, 0,
            _WAVE_MAIN_SPP, False), None, _WAVE_MAIN_SPP, scene, cfg, (), 0)
    sk, _, sscene, scfg, (sparams, smats) = _spectral_fns(dev, 1)
    res["wavefront_spectral"] = (
        lambda: march.render_fused_spectral(
            sscene, sparams, smats, scfg, corners, 0,
            n_samples=_WAVE_MAIN_SPP, mode="wavefront"), None,
        _WAVE_MAIN_SPP, sscene, scfg, (), 0)
    return res


def _tensors(out):
    """A kernel's outputs (a tensor, a dict of planes, or nested tuples and
    lists of them) as a flat list, dict entries by name."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [t for o in out for t in _tensors(o)]


# the kernel behind each of `_main_kernels`' launches (kernels/march.py)
_KERNEL_OF = {"mega_paths": "MEGA_PATHS", "mega_paths_csg_nee": "MEGA_PATHS",
              "mega_paths_sh": "MEGA_PATHS", "mega_paths_exact": "MEGA_PATHS",
              "mega_paths_defer": "MEGA_PATHS_DEFER",
              "mega_paths_defer_exact": "MEGA_PATHS_DEFER",
              "mega_spectral": "MEGA_SPECTRAL",
              "mega_spectral_exact": "MEGA_SPECTRAL",
              "record_paths": "RECORD_PATHS",
              "record_spectral": "RECORD_SPECTRAL",
              "record_wavefront": "RECORD_WAVEFRONT",
              "record_wavefront_nee": "RECORD_WAVEFRONT",
              "march_fused": "MARCH_FUSED",
              "march_fused_step": "MARCH_FUSED",
              "wavefront_paths": "WAVEFRONT_PATHS",
              "wavefront_spectral": "WAVEFRONT_SPECTRAL"}


def _step_compare(got, want):
    """Each `march_fused` launch of a train step against the plain march
    on the same plane (`_planes_compare`).  Returns the max abs t error."""
    def planes(out):
        return {"t": out[0], "mid": out[1], "hit": out[2].int()}

    return max(_planes_compare(
        f"march_fused, train step march {i} {tuple(g[0].shape)}",
        planes(g), planes(w))
        for i, (g, w) in enumerate(zip(got, want)))


# the launches whose output kernel_times(bounds=True) holds against the
# plain run that counts their work
_COMPARED = {"march_fused_step": _step_compare}

# the bounds (ms, "bytes" or "operations") the parity phase counted, by
# the name of a `_main_kernels` launch
PARITY_BOUNDS = {}


def _cuda_ms_each(fn, reps: int) -> list:
    """Milliseconds of each of `reps` calls, by CUDA events."""
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def kernel_times(dev, card, sh_scene_path, bounds=False, only=None):
    """Every kernel at its main path's launch (those named in `only`, when
    given), alone: the mean ms of 3 by CUDA events after one warm-up call,
    whose output is digested as "main: NAME", with the 3 calls' range,
    beside the time recorded before the redesign of the render
    megakernels (`BEFORE_MS`, a constant: not read in this run; time
    another tree in the same call by running this script in its checkout).
    With `bounds`, the launches of `_SCALED` also get their bound, from
    their plain version's work on a 1024^2 run of 8 samples (8 paths)
    scaled to the launch's 128 samples (32 paths), "march_fused_step"
    from its plain marches' work, whose output is also held against the
    warm-up's (`_COMPARED`), and those of `PARITY_BOUNDS` the bound the
    parity phase counted for them.  Prints one `kernel times:` JSON line and
    returns {name: reading}."""
    res = {}
    for name, (kernel, plain, n, scene, cfg, bufs, out_bytes) in \
            _main_kernels(dev, sh_scene_path).items():
        if only is not None and name not in only:
            continue
        out = kernel()
        torch.cuda.synchronize()
        _digest("main: " + name, *_tensors(out))
        compare = _COMPARED.get(name) if bounds else None
        if compare is None:
            del out
        each = _cuda_ms_each(kernel, reps=3)
        ms = sum(each) / len(each)
        r = {"ms": ms, "ms_min": min(each), "ms_max": max(each),
             "recorded_before_ms": BEFORE_MS.get(name)}
        note = ("" if r["recorded_before_ms"] is None else
                f" (recorded before the redesign, BEFORE_MS: "
                f"{r['recorded_before_ms']:.3f} ms, "
                f"{100.0 * (ms / r['recorded_before_ms'] - 1.0):+.2f}%)")
        if bounds and (name in _SCALED or compare):
            m = 8 if name in _SCALED else n
            work = {}
            want = plain(m, work)
            torch.cuda.synchronize()
            if compare:
                r["max_abs_err"] = compare(out, want)
                del out
            del want
            scale = n // m
            scaled = {k: int(work.get(k, 0)) * scale
                      for k in ("march", "shade")}
            r["bound_ms"], r["bound_by"], _ = _bound(
                scene, cfg, scaled, 15 * 4 + _buffer_bytes(*bufs[:2]),
                out_bytes)
            r["bound_scaled_from"] = m
            note += (f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}; the "
                     f"work of {m} scaled by {scale})")
        elif name in PARITY_BOUNDS:
            r["bound_ms"], r["bound_by"] = PARITY_BOUNDS[name]
            note += (f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                     "counted in the parity phase)")
        print(f"time: {name} at its main launch: {ms:.3f} ms ({min(each):.3f}"
              f"-{max(each):.3f}){note} [{card}]", flush=True)
        res[name] = r
    print("kernel times: " + json.dumps({"card": card, **res}), flush=True)
    return res


# the launches a sweep times, by source
_SWEPT = {"mega_paths": ("mega_paths", "mega_paths_sh", "mega_paths_csg_nee",
                         "mega_paths_defer", "mega_paths_exact",
                         "mega_paths_defer_exact", "record_paths"),
          "mega_spectral": ("mega_spectral", "mega_spectral_exact",
                            "record_spectral"),
          "march_fused": ("march_fused", "march_fused_step"),
          "wavefront_paths": ("wavefront_paths", "record_wavefront",
                              "record_wavefront_nee"),
          "wavefront_spectral": ("wavefront_spectral",)}


def _variant_source(csrc, dst, consts):
    """csrc/ copied to `dst` with each `constexpr` constant named in
    `consts` (wherever csrc/ defines it) set to its value there."""
    shutil.copytree(csrc, dst)
    for const, val in consts.items():
        pat = rf"constexpr (int|bool) {const} = [^;]+;"
        hits = 0
        for name in sorted(os.listdir(dst)):
            path = os.path.join(dst, name)
            text = open(path).read()
            new, n = re.subn(pat, rf"constexpr \1 {const} = {val};", text)
            if n:
                open(path, "w").write(new)
                hits += n
        if hits != 1:
            raise AssertionError(f"{const} defined {hits} times in csrc/")


def sweep(dev, card, variants):
    """Variants of kernels timed in one process: csrc/ copied once per
    variant (`variants`: [(label, {constant: value})]), the sources that
    read its constants (`_CONSTS`) built (every nvcc started together,
    registers and spills printed), then each of their kernels at its main
    launch timed (mean of 3 by CUDA events after a warm-up, and the range)
    through the wrappers with that build's entry points.  Every build must
    give the same output bytes.  Prints one `sweep:` JSON line."""
    import ctypes
    from raymarchrenderer_tpu_torch.kernels import build, march
    from raymarchrenderer_tpu_torch.kernels.build import ptxas_usage
    tmp = tempfile.TemporaryDirectory()
    jobs = []               # (variant label, source stem, .cu, .so)
    for label, consts in variants:
        for src in sorted({_CONSTS[c] for c in consts}):
            dst = os.path.join(tmp.name, f"v{len(jobs)}")
            _variant_source(build.CSRC, dst, consts)
            jobs.append((label, src, os.path.join(dst, src + ".cu"),
                         os.path.join(dst, src + ".so")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = list(pool.map(lambda j: build.compile_source(j[2], j[3]),
                             jobs))
    print(f"sweep: {len(jobs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    entries = {"mega_paths": (march.MEGA_PATHS, march.MEGA_PATHS_DEFER,
                              march.RECORD_PATHS),
               "mega_spectral": (march.MEGA_SPECTRAL, march.RECORD_SPECTRAL),
               "march_fused": (march.MARCH_FUSED,),
               "wavefront_paths": (march.WAVEFRONT_PATHS,
                                   march.RECORD_WAVEFRONT),
               "wavefront_spectral": (march.WAVEFRONT_SPECTRAL,)}
    res = {"card": card}
    digests = {}
    with tempfile.TemporaryDirectory() as stmp:
        sh_scene = os.path.join(stmp, "sh.scene")
        write_sh_scene(sh_scene)
        kernels = _main_kernels(dev, sh_scene)
        for (label, src, _, so), log in zip(jobs, logs):
            lib = ctypes.CDLL(so)
            for k in entries[src]:
                fn = getattr(lib, k.entry)
                fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
                k._fn = fn
            row = {_instantiation(fn): (use["registers"],
                                        use.get("spill_stores", 0),
                                        use.get("spill_loads", 0))
                   for fn, use in ptxas_usage(log).items()}
            for inst, use in sorted(row.items()):
                print(f"sweep: {label}, {src} {inst}: {use[0]} registers, "
                      f"{use[1]} / {use[2]} bytes spill stores / loads",
                      flush=True)
            for name in _SWEPT[src]:
                kernel = kernels[name][0]
                out = kernel()
                torch.cuda.synchronize()
                h = hashlib.sha256()
                for t in _tensors(out):
                    h.update(t.detach().contiguous().cpu().numpy().tobytes())
                del out
                if digests.setdefault(name, h.hexdigest()) != h.hexdigest():
                    raise AssertionError(f"{label}: {name}'s output differs "
                                         "from the first build's")
                each = _cuda_ms_each(kernel, reps=3)
                row[name] = (sum(each) / 3, min(each), max(each))
                print(f"sweep: {label}, {name}: {row[name][0]:.3f} ms "
                      f"({min(each):.3f}-{max(each):.3f}) [{card}]",
                      flush=True)
            res[f"{src}, {label}"] = row
    for ks in entries.values():
        for k in ks:
            k._fn = None
    tmp.cleanup()
    print("sweep: " + json.dumps(res), flush=True)
    _log_json("sweep", res)
    return res


def sweep_consts(dev, card, specs):
    """Design variants, all built and timed in one `sweep`: each spec
    "NAME=V1,V2,...[:NAME=...]" sets the constants NAME of csrc/
    (`_CONSTS`) to each combination of their values in turn."""
    import itertools
    variants = []
    for spec in specs:
        axes = [(c, v.split(",")) for c, v in
                (part.split("=") for part in spec.split(":"))]
        unknown = [c for c, _ in axes if c not in _CONSTS]
        if unknown:
            raise SystemExit(f"--sweep-const: no such constant {unknown}; "
                             f"one of {sorted(_CONSTS)}")
        for values in itertools.product(*(v for _, v in axes)):
            consts = {c: v for (c, _), v in zip(axes, values)}
            variants.append((", ".join(f"{c} {v}"
                                       for c, v in consts.items()), consts))
    return sweep(dev, card, variants)


def _entry(name, source, replaces, launches, max_err, ms, plain_ms, bound,
           exact=None, **notes):
    """One kernel of the `kernels` line (every number read in this run,
    the bound computed from it); `exact` is its `normal_taps_0`
    note (the exact-normal instantiation on its parity patch, and its
    launches on the exact-normal main path where one runs it); `notes`
    are further readings of this run."""
    entry = {"name": name, "route": "cuda",
             "source": f"raymarchrenderer_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
    if exact is not None:
        entry["normal_taps_0"] = exact
    entry.update(notes)
    return entry


# Readings of the kernels before the redesign of the render megakernels
# (the tree before it, `python3 chip_smoke.py` and `--kernel-times` on an
# NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6): each kernel's time
# at its main launch (CUDA events, mean of 3), the SHA-256 of each output
# the kernels made (they must stay bit-identical under the same nvcc), the
# nvcc that built them, and each instantiation's SASS counts.  The rows of
# the spectral recorder and the spectral wavefront kernel (times, SASS,
# registers) were recorded later, on the tree before their own redesign
# (`--kernel-times` in its `git archive`, the mean of two runs), in the
# call that timed the redesign; so were the wavefront recorder's (both of
# its launches, and the digest of the NEE launch, which the tree before
# the redesign of the render megakernels did not run).
BEFORE_MS = {
    "march_fused": 2.262,
    "mega_paths": 373.533,
    "mega_paths_csg_nee": 1557.706,
    "mega_paths_defer": 126.047,
    "mega_paths_defer_exact": 130.092,
    "mega_paths_exact": 398.237,
    "mega_paths_sh": 438.527,
    "mega_spectral": 309.276,
    "mega_spectral_exact": 316.855,
    "record_paths": 20.515,
    "record_spectral": 13.537,
    "record_wavefront": 7.600,
    "record_wavefront_nee": 17.152,
    "wavefront_paths": 62.785,
    "wavefront_spectral": 36.335,
}
DIGESTS_BEFORE = {
    "RGB + NEE, csg_demo 256x256 patch at (384, 512), 8 spp":
        "cfe3e143238745a3",
    "RGB + dispersion + NEE + RR, csg_demo 128x128 patch at (448, 448), 2 spp":
        "e80579569a3aef67",
    "RGB SH sky, 256x256 patch at (384, 384), 16 spp":
        "0d965a9df614866f",
    "RGB deferred sky + NEE, two-sphere scene 256x256 patch at (320, 384), 8 spp, exact composite, raw sum":
        "bdf01384660345c5",
    "RGB deferred sky + NEE, two-sphere scene 256x256 patch at (320, 384), 8 spp, mxu composite, raw sum":
        "bdf01384660345c5",
    "RGB deferred sky, default.scene + gradient env 1024x1024, 32 paths (the env main path's launch), raw sum":
        "5ae4b5beff42613a",
    "RGB deferred sky, default.scene + gradient env 1024x1024, 32 paths (the env main path's launch), thr_b bank":
        "38da2ca683b8eff1",
    "RGB deferred sky, default.scene + gradient env 1024x1024, 32 paths (the env main path's launch), thr_g bank":
        "1f070e0ba2394cc0",
    "RGB deferred sky, default.scene + gradient env 1024x1024, 32 paths (the env main path's launch), thr_r bank":
        "b1afba0d8799ecb8",
    "RGB wavefront + NEE + dispersion + RR, csg_demo 128x128 patch, 3 spp, 16 bounces":
        "595ed71dfbd260bb",
    "RGB wavefront, sphere_on_floor 1024x1024, 8 spp, 16 bounces (the wavefront main path's launch)":
        "08f950085e1d13d0",
    "RGB, sphere_on_floor 1024x1024, 128 spp (the main path's launch)":
        "4f8f4a4af7a08452",
    "exact normal, RGB + NEE + dispersion + RR, csg_demo 128x128 patch at (384, 512), 4 spp":
        "db6e5d2686e777fe",
    "exact normal, RGB SH sky, 128x128 patch at (384, 384), 8 spp":
        "ccfc3275058b7046",
    "exact normal, RGB deferred sky, default.scene + gradient env 128x128 patch at (384, 384), 8 paths, raw sum":
        "9cd9aca4b470338c",
    "exact normal, RGB deferred sky, default.scene + gradient env 128x128 patch at (384, 384), 8 paths, thr_b bank":
        "7503a2ac4968ad42",
    "exact normal, RGB deferred sky, default.scene + gradient env 128x128 patch at (384, 384), 8 paths, thr_g bank":
        "70ca22c7c9ca1011",
    "exact normal, RGB deferred sky, default.scene + gradient env 128x128 patch at (384, 384), 8 paths, thr_r bank":
        "5a3bb988013e589e",
    "exact normal, RGB wavefront + NEE + RR, csg_demo 128x128 patch at (384, 384), 3 spp, 16 bounces":
        "0223ea307f5b874f",
    "exact normal, recorder + NEE, csg_demo 128x128 patch at (384, 512), 2 samples":
        "c03d4022680604eb",
    "exact normal, spectral 128x128 patch at (448, 512), 4 spp":
        "3d0776bec2b7a1a7",
    "exact normal, spectral recorder 128x128 patch at (448, 512), 4 samples":
        "07aca42fb948ec38",
    "exact normal, spectral wavefront 128x128 patch at (448, 512), 3 spp, 16 bounces":
        "3fd3cad8e585b3cc",
    "exact normal, wavefront recorder + NEE + RR, csg_demo 128x128 patch at (384, 512)":
        "d9a4c3b21a868761",
    "main path: rgb SH sky (default.scene with environment.sh)":
        "fbf0a86d99f175c7",
    "main path: rgb csg --direct-light":
        "b4e87206def14dca",
    "main path: rgb sphere_on_floor":
        "4f8f4a4af7a08452",
    "main path: rgb sphere_on_floor --normal-taps 0":
        "57c63414fd35255c",
    "main path: spectral":
        "3a10033a3b644274",
    "main path: spectral --normal-taps 0":
        "74d4669e9d141e90",
    "main: march_fused":
        "b68b6b870510ba2a",
    "main: mega_paths":
        "4f8f4a4af7a08452",
    "main: mega_paths_csg_nee":
        "b4e87206def14dca",
    "main: mega_paths_defer":
        "4c3c3805cf441296",
    "main: mega_paths_defer_exact":
        "fd9a00a35d353fec",
    "main: mega_paths_exact":
        "57c63414fd35255c",
    "main: mega_paths_sh":
        "fbf0a86d99f175c7",
    "main: mega_spectral":
        "3a10033a3b644274",
    "main: mega_spectral_exact":
        "74d4669e9d141e90",
    "main: record_paths":
        "8c625eba85904c84",
    "main: record_spectral":
        "2b87c228a805b01e",
    "main: record_wavefront":
        "3382bc1959af3c99",
    "main: record_wavefront_nee":
        "d995de71616ab5e9",
    "main: wavefront_paths":
        "08f950085e1d13d0",
    "main: wavefront_spectral":
        "d663c7648dd4dfc4",
    "march_fused, a shadow-style plane (512, 1024): per-lane t_max, dist_mult -1 inside the ball, inactive lanes":
        "f10ce9cbdd2c8e5e",
    "march_fused, the train launch's primary plane (4x1024, 1024)":
        "b68b6b870510ba2a",
    "recorder + NEE, csg_demo 256x256 patch at (384, 512), 2 samples":
        "cb5502946f59f860",
    "recorder + dispersion + NEE + RR, csg_demo 128x128 patch at (448, 448), 1 sample":
        "b810f69dbbf72589",
    "recorder, sphere_on_floor 1024x1024, 4 samples, 4 bounces (the train path's launch)":
        "8c625eba85904c84",
    "spectral 1024x1024, 128 spp (the main path's launch)":
        "3a10033a3b644274",
    "spectral 128x128 patch at (448, 512), 4 spp":
        "bc7dc1a79aae578b",
    "spectral recorder, 128x128 patch at (448, 512), 4 samples":
        "9f68b9c0e1bdf83f",
    "spectral recorder, spectral_demo 1024x1024, 4 samples, 4 bounces (the spectral train path's launch)":
        "2b87c228a805b01e",
    "spectral wavefront, 1024x1024, 8 spp, 16 bounces (the wavefront main path's launch)":
        "d663c7648dd4dfc4",
    "spectral wavefront, 128x128 patch at (448, 512), 3 spp, 16 bounces":
        "55dfbfd5d465309b",
    "uv: RGB deferred sky + NEE, two-sphere scene 256x256 patch at (320, 384), 8 spp, exact composite":
        "7506da47e2a3a81c",
    "uv: RGB deferred sky + NEE, two-sphere scene 256x256 patch at (320, 384), 8 spp, mxu composite":
        "7506da47e2a3a81c",
    "uv: RGB deferred sky, default.scene + gradient env 1024x1024, 32 paths (the env main path's launch)":
        "3ab8b0b719f1f8b9",
    "uv: exact normal, RGB deferred sky, default.scene + gradient env 128x128 patch at (384, 384), 8 paths":
        "ca34c94bf3ce4226",
    "wavefront recorder + NEE + RR, csg_demo 256x256 patch at (384, 512)":
        "476677e8f8ac6559",
    "wavefront recorder, sphere_on_floor 1024x1024 bounce-0 planes, 1 sample, 4 bounces":
        "3382bc1959af3c99",
}
NVCC_BEFORE = "Build cuda_12.9.r12.9/compiler.36037853_0"
SASS_BEFORE = {
    "march_fused_kernel": {"LDL": 39, "STL": 25, "CALL": 14, "BRX": 7},
    "mega_paths_kernel<Banks>": {"LDL": 82, "STL": 95, "CALL": 43, "BRX": 21},
    "mega_paths_kernel<Banks> exact": {"LDL": 74, "STL": 48, "CALL": 43, "BRX": 21},
    "mega_paths_kernel<DeferSky>": {"LDL": 81, "STL": 89, "CALL": 43, "BRX": 21},
    "mega_paths_kernel<DeferSky> exact": {"LDL": 74, "STL": 60, "CALL": 43, "BRX": 21},
    "mega_paths_kernel<NoBanks>": {"LDL": 82, "STL": 90, "CALL": 43, "BRX": 21},
    "mega_paths_kernel<NoBanks> exact": {"LDL": 74, "STL": 59, "CALL": 43, "BRX": 21},
    "mega_paths_kernel<ShSky>": {"LDL": 76, "STL": 86, "CALL": 42, "BRX": 19},
    "mega_paths_kernel<ShSky> exact": {"LDL": 68, "STL": 55, "CALL": 42, "BRX": 19},
    "mega_spectral_kernel<NoBanks>": {"LDL": 87, "STL": 69, "CALL": 43, "BRX": 21},
    "mega_spectral_kernel<NoBanks> exact": {"LDL": 80, "STL": 38, "CALL": 43, "BRX": 21},
    "record_spectral_kernel<Banks>": {"LDL": 46, "STL": 57, "CALL": 43, "BRX": 0},
    "record_spectral_kernel<Banks> exact": {"LDL": 44, "STL": 66, "CALL": 43, "BRX": 0},
    "record_wavefront_kernel": {"LDL": 146, "STL": 95, "CALL": 45, "BRX": 4},
    "record_wavefront_kernel exact": {"LDL": 118, "STL": 88, "CALL": 47, "BRX": 4},
    "wavefront_paths_kernel": {"LDL": 153, "STL": 103, "CALL": 47, "BRX": 16},
    "wavefront_paths_kernel exact": {"LDL": 132, "STL": 131, "CALL": 50, "BRX": 10},
    "wavefront_spectral_kernel": {"LDL": 129, "STL": 116, "CALL": 47, "BRX": 0},
    "wavefront_spectral_kernel exact": {"LDL": 107, "STL": 75, "CALL": 49, "BRX": 0},
}

# registers, spill stores and spill loads (bytes) of each instantiation
# before the redesign; the build phase prints whether each kept them
PTXAS_BEFORE = {
    "march_fused_kernel": (40, 40, 40),
    "mega_paths_kernel<Banks>": (80, 68, 72),
    "mega_paths_kernel<Banks> exact": (80, 216, 224),
    "mega_paths_kernel<DeferSky>": (80, 40, 68),
    "mega_paths_kernel<DeferSky> exact": (80, 372, 380),
    "mega_paths_kernel<NoBanks>": (80, 56, 68),
    "mega_paths_kernel<NoBanks> exact": (80, 340, 348),
    "mega_paths_kernel<ShSky>": (80, 136, 148),
    "mega_paths_kernel<ShSky> exact": (80, 488, 496),
    "mega_spectral_kernel<NoBanks>": (80, 4, 12),
    "mega_spectral_kernel<NoBanks> exact": (80, 0, 0),
    "record_spectral_kernel<Banks>": (40, 244, 244),
    "record_spectral_kernel<Banks> exact": (40, 236, 252),
    "record_wavefront_kernel": (48, 332, 444),
    "record_wavefront_kernel exact": (56, 268, 264),
    "wavefront_paths_kernel": (64, 160, 220),
    "wavefront_paths_kernel exact": (80, 776, 856),
    "wavefront_spectral_kernel": (40, 232, 268),
    "wavefront_spectral_kernel exact": (56, 168, 176),
}


def _instantiation(fn):
    """A readable name of a mangled kernel: its template's policy, and
    " exact" for an exact-normal instantiation."""
    name = next(k for k in (
        "record_wavefront_kernel", "wavefront_paths_kernel",
        "wavefront_spectral_kernel", "mega_paths_kernel",
        "mega_spectral_kernel", "record_spectral_kernel",
        "march_fused_kernel") if k in fn)
    policy = next((p for p, tag in (
        ("NoBanks", "7NoBanks"), ("ShSky", "5ShSky"),
        ("DeferSky", "8DeferSky"), ("Banks", "5Banks")) if tag in fn), None)
    exact = "ExactNormal" in fn or "ILb1E" in fn
    return (name + (f"<{policy}>" if policy else "")
            + (" exact" if exact else ""))


def build_kernels(card, only=None):
    """Phase 2: every source built by its own nvcc, all started together
    (the entries of one source share its library: one builds, the others
    wait); prints each instantiation's ptxas registers and spills and its
    SASS local-memory loads and stores, calls and indirect branches,
    beside PTXAS_BEFORE and SASS_BEFORE.  `only` (names of
    `_main_kernels`) builds just their kernels.  Returns the kernels."""
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.kernels.build import ptxas_usage
    t0 = time.perf_counter()
    kernels = (march.MEGA_PATHS, march.MEGA_PATHS_DEFER, march.RECORD_PATHS,
               march.RECORD_WAVEFRONT, march.WAVEFRONT_PATHS,
               march.MEGA_SPECTRAL, march.RECORD_SPECTRAL,
               march.WAVEFRONT_SPECTRAL, march.MARCH_FUSED)
    if only is not None:
        wanted = {getattr(march, _KERNEL_OF[name]) for name in only}
        kernels = tuple(k for k in kernels if k in wanted)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    print(f"build: {len(kernels)} kernels of "
          f"{len({k.source for k in kernels})} sources in "
          f"{time.perf_counter() - t0:.2f} s (nvcc " + ", ".join(
              f"{k.source.name} {k.build_seconds:.2f} s" for k in kernels
              if k.build_log) + f") [{card}]", flush=True)
    readings = {}
    libs = {}
    for k in kernels:            # the kernel that built each library first
        if k.build_log or k.library_path() not in libs:
            libs[k.library_path()] = k
    for lib, k in libs.items():
        sass = {_instantiation(fn): c for fn, c in sass_counts(lib).items()}
        usage = {_instantiation(fn): use
                 for fn, use in ptxas_usage(k.build_log).items()}
        for label in sorted(set(usage) | set(sass)):
            use = usage.get(label)
            got = None if use is None else (
                use["registers"], use.get("spill_stores", 0),
                use.get("spill_loads", 0))
            before = PTXAS_BEFORE.get(label)
            if got is None:     # a library built before this run
                note = "registers not logged"
            else:
                note = (f"{got[0]} registers, {got[1]} bytes spill stores, "
                        f"{got[2]} bytes spill loads")
                note += ("" if before is None else " (as before)"
                         if got == before else
                         f" (before: {before[0]}/{before[1]}/{before[2]})")
            ops = sass.get(label)
            if ops is not None:
                sb = SASS_BEFORE.get(label)
                note += "; SASS " + ", ".join(
                    f"{op} {ops[op]}" for op in SASS_OPS) + (
                    "" if sb is None else " (before " + ", ".join(
                        f"{op} {sb[op]}" for op in SASS_OPS) + ")")
            print(f"ptxas: {k.source.name} {label}: {note}", flush=True)
            readings[label] = {"ptxas": got, "sass": ops}
    _log_json("build", readings)
    return kernels


# ---- the drivers: native libraries, tiles, resume, counters, goldens ----

def native_phase(card):
    """Phase 2b: the native host libraries of native/ (encoder, .hdr
    decoder, scheduler) built by g++ into build/, all started together;
    fails if one does not build.  Returns {library: g++ seconds}."""
    from raymarchrenderer_tpu_torch.io import native_bindings as nb
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(nb.LIBRARIES)) as pool:
        handles = list(pool.map(lambda lib: lib.load(), nb.LIBRARIES))
    for lib, handle in zip(nb.LIBRARIES, handles):
        if handle is None:
            raise AssertionError(f"native library lib{lib.name} did not "
                                 f"build: {lib.error}")
    secs = {lib.name: lib.build_seconds for lib in nb.LIBRARIES}
    print(f"native: " + ", ".join(f"lib{k} {v:.2f} s" for k, v in
                                  secs.items())
          + f" by g++ (0.00: built before), {time.perf_counter() - t0:.2f} s "
          f"in all, into {nb.BUILD_DIR} [{card}]", flush=True)
    return secs


def native_calls():
    """{C function: calls} of every native library so far."""
    from raymarchrenderer_tpu_torch.io import native_bindings as nb
    return {fn: n for lib in nb.LIBRARIES for fn, n in lib.calls.items()}


def check_native_used(label, before, card, *fns):
    """Fail unless each C function in `fns` was called since `before` (a
    `native_calls()` snapshot)."""
    now = native_calls()
    used = {fn: now.get(fn, 0) - before.get(fn, 0) for fn in fns}
    print(f"native, {label}: calls {json.dumps(used)} [{card}]", flush=True)
    if not all(used.values()):
        raise AssertionError(f"{label}: the native library was not used "
                             f"({used})")


def _rate(spp, seconds, size=1024):
    return size * size * spp / 1e6 / seconds


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tiles_phase(dev, card):
    """`ProgressiveRenderer(impl="fused")` through the reference's spiral
    of 16 tiles of 256^2 (a 4 x 4 grid of the 1024^2 frame), each tile's
    samples one launch of the RGB kernel: byte-equal to one full-frame
    `render_fused` launch (sphere_on_floor at 128 spp, csg with NEE at 8),
    and two endless passes byte-equal to the running mean of two
    full-frame one-sample launches; 16 launches a pass, the spiral from
    the native scheduler.  Returns the readings."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.tiles import ProgressiveRenderer
    from raymarchrenderer_tpu_torch.scene import builtin

    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    cfg = _main_cfg()
    before = native_calls()
    readings = {}
    for label, scene, nee, spp in (
            ("sphere_on_floor", builtin.sphere_on_floor(), False, 128),
            ("csg --direct-light", builtin.csg_demo(), True, 8)):
        params = scene.init_params(dev)
        pr = ProgressiveRenderer(scene, params, cfg, corners, impl="fused",
                                 direct_light=nee)
        march.MEGA_PATHS.launches = 0
        tiled, tile_s = _timed(lambda: pr.render_pass(spp=spp))
        launches = march.MEGA_PATHS.launches
        full, full_s = _timed(lambda: march.render_fused(
            scene, params, cfg, corners, 0, n_samples=spp,
            direct_light=nee))
        equal = bool(torch.equal(tiled, full))
        readings[label] = {"spp": spp, "tiles_s": tile_s,
                           "tiles_mpix_spp_s": _rate(spp, tile_s),
                           "full_frame_s": full_s,
                           "full_frame_mpix_spp_s": _rate(spp, full_s),
                           "launches": launches, "byte_equal": equal}
        print(f"tiles, {label}: 1024x1024 @ {spp} spp in 16 spiral tiles "
              f"of 256x256, {launches} launches, {tile_s:.3f} s "
              f"({_rate(spp, tile_s):.2f} Mpix*spp/s); one full-frame "
              f"launch {full_s:.3f} s ({_rate(spp, full_s):.2f}); "
              f"byte-equal: {equal} [{card}]", flush=True)
        if launches != 16 or not equal:
            raise AssertionError(f"tiles, {label}: {launches} launches, "
                                 f"byte-equal {equal}")
    scene = builtin.sphere_on_floor()
    params = scene.init_params(dev)
    pr = ProgressiveRenderer(scene, params, cfg, corners, impl="fused")
    march.MEGA_PATHS.launches = 0
    got = pr.endless_passes(2)
    launches = march.MEGA_PATHS.launches
    want = torch.zeros_like(got)
    for p in range(2):
        frame = march.render_fused(scene, params, cfg, corners, p,
                                   n_samples=1)
        want = (want * float(p) + frame * 1.0) / (p + 1.0)
    equal = bool(torch.equal(got, want))
    readings["endless_passes_2"] = {"launches": launches,
                                    "byte_equal": equal}
    print(f"tiles, endless_passes(2), sphere_on_floor: {launches} launches, "
          f"byte-equal to the running mean of 2 full-frame launches: "
          f"{equal} [{card}]", flush=True)
    if launches != 32 or not equal:
        raise AssertionError("tiles: endless passes")
    check_native_used("spiral_tiles", before, card, "rmr_spiral_order")
    return readings


def _flags(argv, **values):
    """argv with each `--flag value` of `values` (underscores as dashes)
    set, appended where argv lacks it."""
    out = list(argv)
    for k, v in values.items():
        flag = "--" + k.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = str(v)
        else:
            out += [flag, str(v)]
    return out


def resume_phase(dev, card):
    """`render --checkpoint` at 64 spp, then `--resume --spp 128`, through
    the CLI at 1024^2 with --chunk 64, spectral and RGB sphere_on_floor:
    byte-equal to one uninterrupted `--spp 128 --chunk 64` run, one launch
    for the resumed 64 samples; a checkpoint of another scene is refused
    (SceneMismatchError).  Returns the readings."""
    from raymarchrenderer_tpu_torch.app import cli
    from raymarchrenderer_tpu_torch.io.checkpoint import (SceneMismatchError,
                                                          load_checkpoint)
    from raymarchrenderer_tpu_torch.kernels import march

    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "resume.png")
        for label, argv, kernel in (
                ("spectral", SPECTRAL_ARGV, march.MEGA_SPECTRAL),
                ("rgb sphere_on_floor", RGB_ARGV, march.MEGA_PATHS)):
            ckpt = os.path.join(tmp, "render.ckpt")

            def run(spp, *extra):
                args = cli.build_parser().parse_args(
                    _flags(argv, chunk=64, spp=spp) + ["--out", out, *extra])
                return cli.cmd_render(args)
            run(64, "--checkpoint", ckpt)
            kernel.launches = 0
            resumed, n, resume_s = run(128, "--checkpoint", ckpt, "--resume")
            launches = kernel.launches
            whole, _, whole_s = run(128)
            equal = bool(torch.equal(resumed, whole))
            st = load_checkpoint(ckpt)
            try:
                cli.cmd_render(cli.build_parser().parse_args(
                    ["render", "--scene", "csg", *_flags(
                        _SIZE, chunk=64), "--out", out, "--checkpoint",
                     ckpt, "--resume"]))
                refused = False
            except SceneMismatchError:
                refused = True
            readings[label] = {
                "resumed_s": resume_s,
                "resumed_mpix_spp_s": _rate(64, resume_s),
                "uninterrupted_s": whole_s,
                "uninterrupted_mpix_spp_s": _rate(128, whole_s),
                "launches": launches, "byte_equal": equal,
                "checkpoint_n": st.n, "other_scene_refused": refused}
            print(f"resume, {label}: 1024x1024, 64 spp checkpointed, resumed "
                  f"to {n:.0f} in {resume_s:.3f} s ({launches} launch, "
                  f"{_rate(64, resume_s):.2f} Mpix*spp/s of the new samples, "
                  f"the checkpoint writes included); uninterrupted 128 spp "
                  f"--chunk 64 {whole_s:.3f} s ({_rate(128, whole_s):.2f}); "
                  f"byte-equal: {equal}; checkpoint n {st.n:.0f}; another "
                  f"scene's resume refused: {refused} [{card}]", flush=True)
            if not (equal and launches == 1 and st.n == 128.0 and refused):
                raise AssertionError(f"resume, {label}: {readings[label]}")
    return readings


def profile_phase(dev, card):
    """bench.py's work counters and march occupancy on the port, at its
    configuration (spectral_demo, 1024^2, relax 2.0, 4 taps, samples from
    1): `spectral_path_profile` over 4 samples, each counter within 0.1%
    of BENCH_r05.json's, and `mega_occupancy_profile` over 4 tiles of 128
    samples within 0.002 of its occupancy.  Plain versions, eagerly, on
    the card.  Returns the readings."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    from raymarchrenderer_tpu_torch.utils.metrics import (
        mega_occupancy_profile, spectral_path_profile)

    with open(os.path.join(_ROOT, "BENCH_r05.json")) as f:
        bench = json.load(f)["parsed"]
    scene, params, mats = spectral_demo(dev)
    cfg = RenderConfig(width=1024, height=1024, relax_omega=2.0,
                       normal_taps=4)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    prof, prof_s = _timed(lambda: spectral_path_profile(
        scene, params, mats, cfg, corners, 1, n_samples=4))
    occ, occ_s = _timed(lambda: mega_occupancy_profile(
        scene, params, mats, cfg, corners, 1, n_samples=128, tiles=4))
    keys = ("segments_per_sample", "march_map_evals_per_sample",
            "hits_per_sample", "map_evals_per_sample")
    rel = {k: abs(prof[k] - bench[k]) / bench[k] for k in keys}
    occ_off = abs(occ["march_occupancy"] - bench["march_occupancy"])
    readings = {**prof, **occ, "profile_s": prof_s, "occupancy_s": occ_s,
                "rel_err": rel, "occupancy_abs_err": occ_off,
                "bench_r05": {k: bench[k] for k in (*keys,
                                                    "march_occupancy")}}
    print("profile: " + json.dumps({**readings, "card": card}), flush=True)
    if occ_s > 90.0:
        print(f"profile: the occupancy count took {occ_s:.1f} s, more than "
              f"90 s (the plain schedule, eagerly) [{card}]", flush=True)
    if max(rel.values()) > 1e-3 or occ_off > 2e-3:
        raise AssertionError(f"profile counters off BENCH_r05.json: {rel}, "
                             f"occupancy {occ_off}")
    return readings


def golden_parity_phase(dev, card):
    """The `parity` verb (`cli.main(["parity"])`, `utils.parity.run_parity`
    on the card): default.scene's parity twin at the 2015 golden pose, the
    x4 goldens (320 x 180), 2048 spp through the RGB kernel in launches of
    64; exit code 0, and every one of the five gated goldens must pass.
    Returns the report."""
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.utils.parity import GATED_GOLDENS
    march.MEGA_PATHS.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        (rc, text), secs = _timed(lambda: _cli(["parity", "--out-dir", tmp]))
    launches = march.MEGA_PATHS.launches
    line = text.strip().splitlines()[-1]
    report = json.loads(line)
    print(f"golden parity: {line}", flush=True)
    w, h = report["size"]
    print(f"golden parity: {len(report['goldens'])} goldens, " + ", ".join(
        f"{g['ref']} {'pass' if g['pass'] else 'FAIL'} (luma r "
        f"{g['luma_pearson_r']}, ssim {g['ssim_luma']})"
        for g in report["goldens"]) + f"; {w}x{h} @ {report['spp']} spp in "
          f"{secs:.3f} s, {launches} launches "
          f"({w * h * report['spp'] / 1e6 / secs:.2f} Mpix*spp/s) [{card}]",
          flush=True)
    if rc != 0 or not report["pass"] or {
            g["ref"] for g in report["goldens"]} != set(GATED_GOLDENS):
        raise AssertionError("golden parity failed")
    return {**report, "seconds": secs, "launches": launches}


# ---- 4c. the frontends: bench, viewer, repl, info, parity, metrics --------

def _cli(argv, stdin=None):
    """`cli.main(argv)` in this process with its stdout captured (and
    `stdin` as its standard input); returns (exit code, stdout)."""
    import contextlib
    import io
    from raymarchrenderer_tpu_torch.app import cli
    buf = io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        sys.stdin = saved
    return rc, buf.getvalue()


def _zero(*kernels):
    for k in kernels:
        k.launches = 0


def bench_verb(card):
    """`bench --size 1024 --spp 128` (BENCH_PROFILE=0: the counters ran in
    4b): a warm-up and two timed launches of the spectral kernel, the JSON
    line printed beside phase 4's spectral render rate."""
    from raymarchrenderer_tpu_torch.kernels import march
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("BENCH_")}
    os.environ["BENCH_PROFILE"] = "0"
    _zero(march.MEGA_SPECTRAL, march.MEGA_PATHS)
    try:
        rc, out = _cli(["bench", "--size", "1024", "--spp", "128"])
    finally:
        os.environ.pop("BENCH_PROFILE")
        os.environ.update(saved)
    launches = march.MEGA_SPECTRAL.launches
    line = json.loads(out.strip().splitlines()[-1])
    print(f"frontends, bench: {json.dumps(line)}; {launches} launches of "
          f"rmr_mega_spectral; phase 4's `render --spectral` "
          f"{MAIN_RATES.get('spectral', float('nan')):.2f} Mpix*spp/s "
          f"[{card}]", flush=True)
    if (rc != 0 or launches != 3 or march.MEGA_PATHS.launches != 0
            or "platform=cuda" not in line["metric"]
            or not line["value"] > 0):
        raise AssertionError(f"bench verb: rc {rc}, {launches} launches, "
                             f"{line}")
    return {**line, "launches": launches}


def _http(base, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        base + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read()) if path != "/api/image.png" else r.read()


def _viewer_wait(base, n, timeout=600):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        st = _http(base, "/api/state")
        if st["error"]:
            raise AssertionError(f"viewer: {st['error']}")
        if st["n"] >= n and not st["rendering"]:
            return st
        time.sleep(0.02)
    raise AssertionError(f"viewer: no image after {timeout} s: {st}")


def viewer_verb(dev, card, sky_path):
    """The viewer (`app.viewer.make_server(port=0, device=cuda)`) in a
    thread, driven over HTTP on localhost: spectral 1024^2 at 128 spp (32
    launches of 4, byte-equal to `render_progressive_fused_spectral` in
    launches of 4), csg with NEE at 512^2, 16 spp (4 launches, byte-equal
    to the same chunks), an orbit that restarts it (another image), a
    reset that gives its bytes again, default.scene under the phase's
    gradient sky (deferred launches only), and a stop that keeps the
    partial image.  Returns the readings."""
    import threading
    from raymarchrenderer_tpu_torch.app import cli
    from raymarchrenderer_tpu_torch.app.viewer import make_server
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)

    kernels = (march.MEGA_SPECTRAL, march.MEGA_PATHS, march.MEGA_PATHS_DEFER)
    srv = make_server(port=0, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    state = srv.viewer_state
    readings = {}

    def run(label, req, ref=None, expect=None):
        _zero(*kernels)
        t0 = time.perf_counter()
        _http(base, "/api/render", req)
        st = _viewer_wait(base, req["spp"])
        secs = time.perf_counter() - t0
        counts = {k.entry: k.launches for k in kernels}
        img = state.accum.copy()
        equal = None
        if ref is not None:
            scene = cli.build_scene(req["scene"], req.get("env_map"))
            cfg = RenderConfig(
                width=req["width"], height=req["height"], spp=req["spp"],
                max_steps=req["max_steps"], max_bounces=req["max_bounces"])
            corners = Camera(aspect=cfg.width / cfg.height).corner_rays_flat(
                dev)
            want = ref(scene, scene.init_params(dev), cfg, corners)
            equal = bool(np.array_equal(img, want.cpu().numpy()))
        readings[label] = {"seconds": secs, "launches": counts,
                           "n": st["n"], "byte_equal": equal,
                           "mean": float(img.mean())}
        print(f"frontends, viewer {label}: {req['width']}x{req['height']} "
              f"@ {st['n']:.0f} spp in {secs:.3f} s (request to image, "
              f"polled), launches {json.dumps(counts)}, byte-equal to the "
              f"library's progressive render: {equal}, image mean "
              f"{img.mean():.6f} [{card}]", flush=True)
        if (expect is not None and counts != expect) or equal is False or \
                not np.isfinite(img).all() or not img.mean() > 0.0:
            raise AssertionError(f"viewer {label}: {readings[label]}")
        return img

    def fused(nee):
        return lambda scene, params, cfg, corners: \
            march.render_progressive_fused(
                scene, params, cfg, corners, spp=16, samples_per_launch=4,
                direct_light=nee)[0]

    steps = {"max_steps": 512, "max_bounces": 16}
    try:
        run("spectral", {"scene": "sphere_on_floor", "spectral": True,
                         "width": 1024, "height": 1024, "spp": 128, **steps},
            lambda scene, params, cfg, corners:
                march.render_progressive_fused_spectral(
                    scene, params, band_table(scene, dev), cfg, corners,
                    spp=128, samples_per_launch=4)[0],
            {"rmr_mega_spectral": 32, "rmr_mega_paths": 0,
             "rmr_mega_paths_defer": 0})
        nee = {"scene": "csg", "direct_light": True, "width": 512,
               "height": 512, "spp": 16, **steps}
        rgb_counts = {"rmr_mega_spectral": 0, "rmr_mega_paths": 4,
                      "rmr_mega_paths_defer": 0}
        first = run("csg --direct-light", nee, fused(True), rgb_counts)
        _zero(*kernels)
        pose = _http(base, "/api/camera", {"op": "orbit", "ax": 0.4,
                                           "ay": 0.1})
        _viewer_wait(base, 16)
        orbit_launches = march.MEGA_PATHS.launches
        orbited = state.accum.copy()
        _http(base, "/api/camera", {"op": "reset"})
        st = _viewer_wait(base, 16)
        reset_equal = bool(np.array_equal(state.accum, first))
        readings["camera"] = {
            "orbit_launches": orbit_launches, "orbit_pose": pose,
            "orbit_changed_image": not np.array_equal(orbited, first),
            "reset_eye": st["camera"]["eye"],
            "reset_byte_equal": reset_equal}
        print(f"frontends, viewer camera: an orbit restarted the render "
              f"({orbit_launches} launches, another image: "
              f"{readings['camera']['orbit_changed_image']}); reset: eye "
              f"{st['camera']['eye']}, the first image's bytes: "
              f"{reset_equal} [{card}]", flush=True)
        if (orbit_launches != 4 or not readings["camera"][
                "orbit_changed_image"] or not reset_equal
                or st["camera"]["eye"] != [0.0, 4.0, -6.0]):
            raise AssertionError(f"viewer camera: {readings['camera']}")
        run("default.scene under the gradient sky",
            {"scene": ENV_SCENE, "env_map": sky_path, "width": 512,
             "height": 512, "spp": 16, **steps}, fused(False),
            {"rmr_mega_spectral": 0, "rmr_mega_paths": 0,
             "rmr_mega_paths_defer": 4})
        _zero(*kernels)
        _http(base, "/api/render", {**nee, "spp": 4096})
        deadline = time.perf_counter() + 600
        while _http(base, "/api/state")["n"] < 8:
            if time.perf_counter() > deadline:
                raise AssertionError("viewer stop: no progress")
            time.sleep(0.01)
        _http(base, "/api/stop", {})
        st = _http(base, "/api/state")
        time.sleep(0.2)
        later = _http(base, "/api/state")
        kept = state.accum is not None and float(state.accum.mean()) > 0.0
        readings["stop"] = {"n": st["n"], "n_later": later["n"],
                            "rendering": st["rendering"], "kept": kept,
                            "launches": march.MEGA_PATHS.launches}
        print(f"frontends, viewer stop: at {st['n']:.0f} of 4096 spp, "
              f"rendering {st['rendering']}, n {later['n']:.0f} 0.2 s "
              f"later, partial image kept: {kept}, "
              f"{march.MEGA_PATHS.launches} launches [{card}]", flush=True)
        if (st["rendering"] or not 8 <= st["n"] < 4096
                or later["n"] != st["n"] or not kept
                or march.MEGA_PATHS.launches != st["n"] // 4):
            raise AssertionError(f"viewer stop: {readings['stop']}")
    finally:
        state.stop()
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    return readings


def repl_verb(dev, card):
    """`repl` fed `samples 128`, `image_width 1024`, `image_height 1024`,
    `grid_width 4`, `grid_height 4`, `render`, `save`: 16 launches of the
    RGB kernel (the spiral tiles), the saved image byte-equal to one
    full-frame launch at the repl's configuration."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.scene import builtin

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "repl.npy")
        _zero(march.MEGA_PATHS)
        t0 = time.perf_counter()
        rc, text = _cli(["repl"], "samples 128\nimage_width 1024\n"
                        "image_height 1024\ngrid_width 4\ngrid_height 4\n"
                        f"render\nsave {out}\nquit\n")
        secs = time.perf_counter() - t0
        launches = march.MEGA_PATHS.launches
        img = np.load(out)
    scene = builtin.sphere_on_floor()
    cfg = RenderConfig(width=1024, height=1024, spp=128)
    want = march.render_fused(scene, scene.init_params(dev), cfg,
                              Camera(aspect=1.0).corner_rays_flat(dev), 0,
                              n_samples=128)
    equal = bool(np.array_equal(img, want.cpu().numpy()))
    render_s = float(re.search(r"render time: ([\d.]+)s", text).group(1))
    print(f"frontends, repl: 1024x1024 @ 128 spp in 16 spiral tiles, "
          f"{launches} launches, render {render_s:.2f} s, session "
          f"{secs:.3f} s; the saved image byte-equal to one full-frame "
          f"launch: {equal} [{card}]", flush=True)
    if rc != 0 or launches != 16 or not equal or "16/16" not in text:
        raise AssertionError(f"repl: rc {rc}, {launches} launches, "
                             f"byte-equal {equal}")
    return {"launches": launches, "render_s": render_s, "session_s": secs,
            "byte_equal": equal}


def info_verb(card):
    rc, text = _cli(["info", "--scene", "csg"])
    info = json.loads(text)
    print(f"frontends, info --scene csg: {json.dumps(info)} [{card}]",
          flush=True)
    if rc != 0 or info != {"materials": 4, "objects": 4, "lights": 1,
                           "env_map": False, "differentiable_params": 78}:
        raise AssertionError(f"info: rc {rc}, {info}")
    return info


def metrics_profile_verb(card):
    """`render --spectral --metrics --profile` at the headline: one launch,
    the JSONL events `render_start` / `render_done`, and a trace holding
    the `record_function` span of `rmr_mega_spectral` (and however many
    GPU kernel events CUPTI recorded)."""
    from raymarchrenderer_tpu_torch.kernels import march
    with tempfile.TemporaryDirectory() as tmp:
        m, prof = os.path.join(tmp, "m.jsonl"), os.path.join(tmp, "prof")
        _zero(march.MEGA_SPECTRAL)
        rc, text = _cli(SPECTRAL_ARGV + ["--metrics", m, "--profile", prof,
                                         "--out",
                                         os.path.join(tmp, "o.png")])
        launches = march.MEGA_SPECTRAL.launches
        with open(m) as f:
            events = [json.loads(x) for x in f]
        traces = [os.path.join(prof, x) for x in os.listdir(prof)]
        with open(traces[0]) as f:
            trace = json.load(f)["traceEvents"]
    spans = [e for e in trace if e.get("name") == "rmr_mega_spectral"]
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    ours = [e for e in kernels if "mega_spectral" in e.get("name", "")]
    readings = {
        "launches": launches, "events": [e["event"] for e in events],
        "render_done": events[-1], "trace_events": len(trace),
        "spans": sorted({e.get("cat") for e in spans}),
        "span_count": len(spans), "gpu_kernel_events": len(kernels),
        "gpu_kernel_events_mega_spectral": len(ours),
        "mega_spectral_gpu_ms": sum(e.get("dur", 0) for e in ours) / 1e3}
    print("frontends, render --metrics --profile: " + json.dumps(
        {**readings, "card": card}), flush=True)
    if (rc != 0 or launches != 1 or readings["events"] != [
            "render_start", "render_done"]
            or set(events[0]) != {"ts", "event", "width", "height", "spp",
                                  "impl", "platform"}
            or events[0]["platform"] != "cuda" or not spans):
        raise AssertionError(f"render --metrics --profile: {readings}")
    return readings


def guards_check(dev, card):
    """`checked_render_sample` on the card at 64^2: clean parameters pass,
    NaN parameters raise."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.scene import builtin
    from raymarchrenderer_tpu_torch.scene.graph import (param_leaves,
                                                        params_replace)
    from raymarchrenderer_tpu_torch.utils import checked_render_sample
    scene = builtin.csg_demo()
    params = scene.init_params(dev)
    cfg = RenderConfig(width=64, height=64, max_steps=128, max_bounces=4)
    corners = Camera(aspect=1.0).corner_rays_flat(dev)
    err, img = checked_render_sample(scene, params, cfg, corners, 0,
                                     direct_light=True)
    bad = params_replace(params, [x * float("nan")
                                  for x in param_leaves(params)])
    try:
        checked_render_sample(scene, bad, cfg, corners, 0)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print(f"frontends, checked_render_sample (csg, NEE, 64x64 on "
          f"{img.device}): clean {err}, NaN parameters raised {raised!r} "
          f"[{card}]", flush=True)
    if err is not None or raised is None or img.device.type != "cuda":
        raise AssertionError("checked_render_sample on the card")
    return {"clean": err, "nan": raised}


def frontends_phase(dev, card, sky_path):
    """Phase 4c: the frontends on the card, each verb with its kernels'
    launch counters zeroed just before and read just after (readings in
    smoke_out/frontends.json)."""
    t0 = time.perf_counter()
    readings = {"bench": bench_verb(card),
                "viewer": viewer_verb(dev, card, sky_path),
                "repl": repl_verb(dev, card), "info": info_verb(card),
                "golden_parity": golden_parity_phase(dev, card),
                "metrics_profile": metrics_profile_verb(card),
                "guards": guards_check(dev, card)}
    readings["seconds"] = time.perf_counter() - t0
    print(f"frontends: phase 4c in {readings['seconds']:.1f} s [{card}]",
          flush=True)
    _log_json("frontends", readings)
    return readings


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="build, print the registers, spills and SASS "
                    "counts, time every kernel at its main launch alone and "
                    "digest its output; no plain version runs")
    ap.add_argument("--only", metavar="NAME,NAME,...",
                    help="with --kernel-times: build and time only these "
                    "kernels (names of the kernels line)")
    ap.add_argument("--frontends", action="store_true",
                    help="build the render kernels and run phase 4c (the "
                    "frontends) alone")
    ap.add_argument("--sweep-min-blocks", metavar="N,N,...",
                    help="time the kernels built with each launch bound in "
                    "the list, each source's bound on its own (a "
                    "--sweep-const of each; no plain version)")
    ap.add_argument("--sweep-const", metavar="NAME=V,V,...[:NAME=...]",
                    action="append", default=[],
                    help="time the kernels built with schedule constants "
                    f"of csrc/ ({', '.join(sorted(_CONSTS))}) set to each "
                    "combination of the values (repeatable)")
    opts = ap.parse_args(argv)
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _card()
    print(card, flush=True)     # nvidia-smi's name, power.limit
    nvcc = _nvcc_version()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc "
          f"{nvcc}", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    ok = json.dumps({"ok": True, "device": device})

    def partial(mode):   # the last line of a run of one mode, not a proof
        return json.dumps({"ok": True, "partial": mode, "device": device})

    specs = list(opts.sweep_const)
    if opts.sweep_min_blocks:
        specs += [f"{const}={opts.sweep_min_blocks}"
                  for _, const in _BOUNDS.values()]
    if specs:
        sweep_consts(dev, card, specs)
        print(partial("sweep"))
        return 0

    # 2. build; a full run counts bench.py's work (4b: plain versions,
    # no kernel) on the card meanwhile
    from raymarchrenderer_tpu_torch.kernels import march
    only = opts.only.split(",") if opts.only else None
    if opts.frontends:
        only = ["mega_paths", "mega_spectral", "mega_paths_defer"]
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(build_kernels, card, only)
        profile = (None if opts.frontends or opts.kernel_times
                   else profile_phase(dev, card))
        built.result()
    native_s = native_phase(card)
    if opts.frontends:
        with tempfile.TemporaryDirectory() as tmp:
            from raymarchrenderer_tpu_torch.io import save_hdr
            sky_path = os.path.join(tmp, "sky.hdr")
            save_hdr(sky_path, gradient_env())
            frontends_phase(dev, card, sky_path)
        print(partial("frontends"))
        return 0
    if opts.kernel_times:
        with tempfile.TemporaryDirectory() as tmp:
            sh_scene = os.path.join(tmp, "sh.scene")
            write_sh_scene(sh_scene)
            _log_json("kernel_times", kernel_times(dev, card, sh_scene,
                                                   only=only))
        check_digests(nvcc)
        print(partial("kernel_times"))
        return 0

    # 3. parity (its launches do not count for the main paths)
    p_err, p_ms, p_plain, p_bound = parity_paths(dev, card)
    s_err, s_ms, s_plain, s_bound = parity_spectral(dev, card)
    r_err, r_ms, r_plain, r_bound = parity_record(dev, card)
    m_err, m_ms, m_plain, m_bound = parity_march(dev, card)
    parity_grads(dev, card)
    rs_err, rs_ms, rs_plain, rs_bound = parity_record_spectral(dev, card)
    w_err, w_ms, w_plain, w_bound, w_nee = parity_wavefront(dev, card)
    parity_spectral_grads(dev, card)
    d_err, d_ms, d_plain, d_bound = parity_defer(dev, card)
    tmp_dir = tempfile.TemporaryDirectory()
    sh_scene = os.path.join(tmp_dir.name, "sh.scene")
    write_sh_scene(sh_scene)
    sky_path = os.path.join(tmp_dir.name, "sky.hdr")
    from raymarchrenderer_tpu_torch.io import save_hdr
    save_hdr(sky_path, gradient_env())
    p_err = max(p_err, parity_sh(dev, card, sh_scene))
    wp_err, wp_ms, wp_plain, wp_bound = parity_wavefront_paths(dev, card)
    ws_err, ws_ms, ws_plain, ws_bound = parity_wavefront_spectral(dev, card)
    exact_notes = parity_exact(dev, card, sh_scene)
    if exact_notes["record_paths"]["max_abs_err"] != 0.0:
        raise AssertionError("recorder #5's exact-normal patch is off its "
                             "plain version")
    p_err = max(p_err, parity_sized_tables(dev, card))
    times = kernel_times(dev, card, sh_scene, bounds=True)
    _log_json("kernel_times", times)

    # 4. main paths
    before_main = native_calls()
    s_launches = main_path("spectral", SPECTRAL_ARGV, march.MEGA_SPECTRAL,
                           card)
    p_launches = main_path("rgb sphere_on_floor", RGB_ARGV, march.MEGA_PATHS,
                           card)
    main_path("rgb csg --direct-light", NEE_ARGV, march.MEGA_PATHS, card)
    d_launches = env_main_path(dev, card, sky_path)
    main_path("rgb SH sky (default.scene with environment.sh)",
              ["render", "--scene", sh_scene, *_SIZE], march.MEGA_PATHS,
              card)
    steps = int(TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 1])

    def radius(tree):            # sphere_on_floor's ball radius
        return tree["objects"][1][1]

    def ball_albedo(tree):
        return tree["materials"][2][0]

    def csg_radius(tree):        # the smooth union's larger sphere
        return tree["objects"][3][1]

    # without NEE, sphere_on_floor's radiance is piecewise constant in
    # geometry (diffuse albedos and an emitter), so its radius gradient is
    # 0 in both packages; the ball's albedo carries the check there, and
    # the NEE run checks a radius
    def target(scene_name, size, direct_light, leaf):
        return lambda path: _write_target(path, dev, scene_name, size,
                                          direct_light, leaf)

    r_launches = train_path(
        "train sphere_on_floor 1024x1024 (recorded)", TRAIN_ARGV, dev, card,
        target("sphere_on_floor", 1024, False, radius), ball_albedo,
        {march.RECORD_PATHS: steps, march.MEGA_PATHS: None})[
            march.RECORD_PATHS]
    m_launches = fused_train_path(
        dev, card, target("sphere_on_floor", 1024, False, radius),
        ball_albedo)
    train_path("train csg --direct-light 512x512 (recorded)", TRAIN_NEE_ARGV,
               dev, card, target("csg_demo", 512, True, csg_radius),
               csg_radius,
               {march.RECORD_PATHS: steps, march.MEGA_PATHS: None})
    # spectral inverse rendering: the radiance is piecewise constant in
    # geometry (no scene leaf's gradient is non-zero, in both packages);
    # the band rows carry the check
    rs_launches = train_path(
        "train --spectral sphere_on_floor 1024x1024 (recorded)",
        TRAIN_SPECTRAL_ARGV, dev, card,
        lambda path: _write_spectral_target(path, dev, 1024), None,
        {march.RECORD_SPECTRAL: steps, march.MEGA_SPECTRAL: None,
         march.RECORD_PATHS: 0, march.MARCH_FUSED: 0})[march.RECORD_SPECTRAL]
    train_path("train --spectral sphere_on_floor 256x256 --impl fused",
               TRAIN_SPECTRAL_FUSED_ARGV, dev, card,
               lambda path: _write_spectral_target(path, dev, 256), None,
               {march.MARCH_FUSED: None, march.MEGA_SPECTRAL: None,
                march.RECORD_SPECTRAL: 0})
    w_launches = wavefront_path(dev, card)
    env_train_path(dev, card, sky_path)
    wp_launches, ws_launches = wavefront_paths_path(dev, card)
    # the exact normal's main paths (each counter zeroed just before)
    exact_notes["mega_spectral"]["main_path_launches"] = main_path(
        "spectral --normal-taps 0", exact(SPECTRAL_ARGV), march.MEGA_SPECTRAL,
        card)
    exact_notes["mega_paths"]["main_path_launches"] = main_path(
        "rgb sphere_on_floor --normal-taps 0", exact(RGB_ARGV),
        march.MEGA_PATHS, card)
    exact_notes["mega_paths_defer"]["main_path_launches"] = env_main_path(
        dev, card, sky_path, exact(ENV_ARGV), "rgb --env-map --normal-taps 0",
        "env perf (exact normal)")
    exact_notes["record_paths"]["main_path_launches"] = exact_train_path(
        dev, card)
    check_native_used("save_image on the main paths", before_main, card,
                      "rmr_linear_to_srgb_u8", "rmr_write_png")

    # 4b. the drivers: tiles, resume, the work counters
    _log_json("drivers", {
        "native_build_s": native_s, "tiles": tiles_phase(dev, card),
        "resume": resume_phase(dev, card),
        "profile": profile})

    # 4c. the frontends: bench, viewer, repl, info, parity (the goldens),
    # render --metrics --profile, the NaN guard
    frontends_phase(dev, card, sky_path)
    tmp_dir.cleanup()

    # 5. perf
    perf(dev, card)
    train_perf(dev, card)
    fused_train_perf(dev, card)
    spectral_train_perf(dev, card)
    env_train_perf(dev, card)
    _log_json("occupancy", OCCUPANCY)
    check_digests(nvcc)

    print(json.dumps({"kernels": [
        _entry("mega_paths", "mega_paths.cu",
               "raymarchrenderer_tpu/kernels/march.py:395", p_launches,
               p_err, p_ms, p_plain, p_bound,
               exact_notes["mega_paths"]),
        _entry("mega_spectral", "mega_spectral.cu",
               "raymarchrenderer_tpu/kernels/march.py:782", s_launches,
               s_err, s_ms, s_plain, s_bound,
               exact_notes["mega_spectral"]),
        _entry("record_paths", "mega_paths.cu",
               "raymarchrenderer_tpu/kernels/record.py:395", r_launches,
               r_err, r_ms, r_plain, r_bound,
               exact_notes["record_paths"]),
        _entry("march_fused", "march_fused.cu",
               "raymarchrenderer_tpu/kernels/march.py:575", m_launches,
               max(m_err, times["march_fused_step"]["max_abs_err"]), m_ms,
               m_plain, m_bound, train_step={
                   k: times["march_fused_step"][k] for k in (
                       "ms", "bound_ms", "bound_by", "max_abs_err")}),
        _entry("record_spectral", "mega_spectral.cu",
               "raymarchrenderer_tpu/kernels/record.py:513", rs_launches,
               rs_err, rs_ms, rs_plain, rs_bound,
               exact_notes["record_spectral"]),
        _entry("record_wavefront", "wavefront_paths.cu",
               "raymarchrenderer_tpu/kernels/record.py:274", w_launches,
               w_err, w_ms, w_plain, w_bound,
               exact_notes["record_wavefront"], nee_launch=w_nee),
        _entry("mega_paths_defer", "mega_paths.cu",
               "raymarchrenderer_tpu/kernels/march.py:395 mega+defer_sky",
               d_launches, d_err, d_ms, d_plain, d_bound,
               exact_notes["mega_paths_defer"]),
        _entry("wavefront_paths", "wavefront_paths.cu",
               "raymarchrenderer_tpu/kernels/march.py:395 wavefront",
               wp_launches, wp_err, wp_ms, wp_plain, wp_bound,
               exact_notes["wavefront_paths"]),
        _entry("wavefront_spectral", "wavefront_spectral.cu",
               "raymarchrenderer_tpu/kernels/march.py:782 wavefront",
               ws_launches, ws_err, ws_ms, ws_plain, ws_bound,
               exact_notes["wavefront_spectral"])]}))
    print(ok)
    return 0


if __name__ == "__main__":
    sys.exit(main())
