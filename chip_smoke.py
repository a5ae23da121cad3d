"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # exits 0 when every phase passes

Phases (any failure raises and the script exits non-zero):

  1. device — a CUDA card must be present; print its name and power limit;
  2. build  — compile csrc/mega_paths.cu and csrc/mega_spectral.cu with
     nvcc (sm_90a), one process each, started together; time each;
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
     Bars: without NEE the JAX package's kernel bar, fewer than 1e-3 of the
     values off by more than 1e-5; with NEE its NEE bar, fewer than 1e-3
     off by more than 1e-3 and rtol 5e-3 / atol 1e-3.  The main launches
     are timed (CUDA events), and a second run of the plain version there
     counts the map evaluations these inputs need, for the kernel's
     operation bound;
  4. main paths — the port's CLI in-process, each with its kernel's launch
     counter zeroed just before and read just after:
       render --spectral --scene data/scenes/spectral.scene ...
       render --scene sphere_on_floor ...
       render --scene csg --direct-light ...
     all at --width 1024 --height 1024 --spp 128 --chunk 128 --relax 2.0
     --normal-taps 4; the counter must have risen, the image be finite and
     non-zero and the PNG written;
  5. perf — each kernel and its plain version at 1024^2 with 8 samples per
     launch (the CLI's default chunk), and the RGB kernel at 128, one
     `perf:` JSON line.

The line before the last is a JSON object with one entry per kernel of the
paths; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX.
"""
from __future__ import annotations

import json
import os
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
    return RenderConfig(width=1024, height=1024, spp=128, relax_omega=2.0,
                        normal_taps=4, **kw)


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
    """(kernel, plain, scene, cfg, params) for the RGB path: the wrapper
    on CUDA tensors and the plain version on the same tensors, each
    returning the (ph, pw, 3) mean over `n` samples from sample 0; `plain`
    takes an optional work-count dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_paths
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.scene import builtin

    scene = getattr(builtin, scene_name)()
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


def _spectral_fns(dev, n, origin_xy=(0, 0), patch_shape=None):
    """As `_paths_fns`, for the spectral path on spectral_demo()."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_spectral
    from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)

    scene, params, mats = spectral_demo(dev)
    cfg = _main_cfg()
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


def _bound(scene, cfg, work, in_bytes, out_bytes):
    """The least time the card could take for one launch: the larger of
    its bytes (each input read once, each output written once) over the
    HBM rate and its FP32 operations over the FP32 peak.  Operations are
    the map evaluations these inputs need, as counted by the plain version
    (march steps of live lanes, and per shaded hit one material lookup and
    `normal_taps` taps), times the object program's FP32 cost; integer RNG
    hashing and material arithmetic are left out, so the bound is low.
    Returns (ms, "bytes" or "operations", operations)."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import map_flops
    mf = map_flops(scene)
    march, shade = int(work["march"]), int(work["shade"])
    taps = cfg.normal_taps
    ops = (march * (mf + MARCH_STEP_FLOPS)
           + shade * ((1 + taps) * mf + 6 * taps + 11))
    t_ops, t_bytes = ops / PEAK_FP32, (in_bytes + out_bytes) / PEAK_BYTES
    print(f"bound: {march} march and {shade} shade evaluations of a "
          f"{mf}-FLOP map, {ops:.4e} FP32 ops = {t_ops * 1e3:.3f} ms; "
          f"{in_bytes + out_bytes} bytes = {t_bytes * 1e3:.4f} ms",
          flush=True)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops)


def _main_launch(label, kernel, plain, card):
    """Kernel vs plain at a main path's own launch: parity, the kernel's
    time (mean of 3), the plain version's time (one run), then one more
    plain run that counts the work for the bound, outside that time.
    Returns (max abs err, ms, plain ms, work)."""
    got = kernel()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    max_err = _compare(label, got, want)
    del got, want
    ms = _cuda_ms(kernel, reps=3, warmup=False)
    work = {}
    count_ms = _cuda_ms(lambda: plain(work), reps=1, warmup=False)
    print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (with work "
          f"counters {count_ms:.3f} ms) [{card}]", flush=True)
    return max_err, ms, plain_ms, work


def _buffer_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def parity_paths(dev, card):
    """The RGB kernel: the main path's launch, then the NEE and the
    dispersion + NEE + roulette patches."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers)
    kernel, plain, scene, cfg, params = _paths_fns(dev, "sphere_on_floor",
                                                   128)
    prog, data = paths_buffers(scene, params, dev)
    in_bytes = 15 * 4 + _buffer_bytes(prog, data)
    max_err, ms, plain_ms, work = _main_launch(
        "RGB, sphere_on_floor 1024x1024, 128 spp (the main path's launch)",
        kernel, plain, card)
    bound = _bound(scene, cfg, work, in_bytes, 1024 * 1024 * 3 * 4)

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
    prog, data = spectral_buffers(scene, params, mats, dev)
    in_bytes = 15 * 4 + _buffer_bytes(prog, data)
    max_err, ms, plain_ms, work = _main_launch(
        "spectral 1024x1024, 128 spp (the main path's launch)", kernel,
        plain, card)
    bound = _bound(scene, cfg, work, in_bytes, 1024 * 1024 * 3 * 4)
    kernel, plain, *_ = _spectral_fns(dev, 4, _SPEC_PATCH, (128, 128))
    max_err = max(max_err, _compare(
        f"spectral 128x128 patch at {_SPEC_PATCH}, 4 spp", kernel(),
        plain()))
    return max_err, ms, plain_ms, bound


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
        if not mean > 0.0:
            raise AssertionError(f"{label}: the image is black")
    rate = 1024 * 1024 * n / 1e6 / render_s
    print(f"main path, {label}: 1024x1024 @ {n:.0f} spp, render "
          f"{render_s:.3f} s ({rate:.2f} Mpix*spp/s), wall with scene setup "
          f"and PNG {wall:.3f} s, {launches} launch(es), image mean "
          f"{mean:.6f} [{card}]", flush=True)
    return launches


def perf(dev, card):
    """Kernels and plain versions at 1024^2 with 8 samples per launch (the
    CLI's default chunk), and the RGB kernel at 128 (the spectral one's 128
    is timed in the parity phase)."""
    res = {"card": card}
    for name, fns in (("rgb", lambda n: _paths_fns(dev, "sphere_on_floor",
                                                   n)[:2]),
                      ("spectral", lambda n: _spectral_fns(dev, n)[:2])):
        kernel, plain = fns(8)
        res[f"{name}_kernel_ms_n8"] = _cuda_ms(kernel, reps=3)
        res[f"{name}_plain_ms_n8"] = _cuda_ms(plain, reps=1, warmup=False)
    res["rgb_kernel_ms_n128"] = _cuda_ms(_paths_fns(
        dev, "sphere_on_floor", 128)[0], reps=3)
    for key in [k for k in res if k.endswith("_ms_n8")]:
        res[key.replace("_ms_n8", "_mpix_spp_per_s_n8")] = (
            1024 * 1024 * 8 / 1e3 / res[key])
    res["rgb_kernel_mpix_spp_per_s_n128"] = (
        1024 * 1024 * 128 / 1e3 / res["rgb_kernel_ms_n128"])
    print("perf: " + json.dumps(res), flush=True)


def _entry(name, source, replaces, launches, max_err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda",
            "source": f"raymarchrenderer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _card()
    print(card, flush=True)     # nvidia-smi's name, power.limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build, one nvcc per kernel, all started together
    from raymarchrenderer_tpu_torch.kernels import march
    t0 = time.perf_counter()
    kernels = (march.MEGA_PATHS, march.MEGA_SPECTRAL)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    print(f"build: both kernels in {time.perf_counter() - t0:.2f} s (nvcc "
          f"{march.MEGA_PATHS.source.name} "
          f"{march.MEGA_PATHS.build_seconds:.2f} s, "
          f"{march.MEGA_SPECTRAL.source.name} "
          f"{march.MEGA_SPECTRAL.build_seconds:.2f} s) [{card}]", flush=True)

    # 3. parity (its launches do not count for the main paths)
    p_err, p_ms, p_plain, p_bound = parity_paths(dev, card)
    s_err, s_ms, s_plain, s_bound = parity_spectral(dev, card)

    # 4. main paths
    s_launches = main_path("spectral", SPECTRAL_ARGV, march.MEGA_SPECTRAL,
                           card)
    p_launches = main_path("rgb sphere_on_floor", RGB_ARGV, march.MEGA_PATHS,
                           card)
    main_path("rgb csg --direct-light", NEE_ARGV, march.MEGA_PATHS, card)

    # 5. perf
    perf(dev, card)

    print(json.dumps({"kernels": [
        _entry("mega_paths", "mega_paths.cu",
               "raymarchrenderer_tpu/kernels/march.py:395", p_launches,
               p_err, p_ms, p_plain, p_bound),
        _entry("mega_spectral", "mega_spectral.cu",
               "raymarchrenderer_tpu/kernels/march.py:782", s_launches,
               s_err, s_ms, s_plain, s_bound)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
