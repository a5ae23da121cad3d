"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # exits 0 when every phase passes

Phases (any failure raises and the script exits non-zero):

  1. device — a CUDA card must be present; print its name and power limit;
  2. build  — compile csrc/mega_spectral.cu with nvcc (sm_90a) and time it;
  3. parity — `render_fused_spectral` on CUDA tensors (the hand-written
     kernel) against the plain PyTorch version `trace_mega_spectral` on the
     same CUDA tensors, spectral_demo() with the production knobs: first at
     the main path's own launch (the whole 1024^2 frame, origin (0, 0),
     128 samples), then on a 128x128 patch at a non-zero origin with 4
     samples.  The bar is the JAX package's own kernel bar: fewer than
     1e-3 of the values off by more than 1e-5.  Both are timed at the
     main path's launch (CUDA events);
  4. main path — the port's CLI in-process:
     render --spectral --scene data/scenes/spectral.scene --width 1024
     --height 1024 --spp 128 --chunk 128 --relax 2.0 --normal-taps 4;
     the kernel's launch counter is zeroed just before and must have
     risen; the image must be finite and non-zero and the PNG written;
  5. perf — the kernel and its plain version at 1024^2 with 8 samples per
     launch (the CLI's default chunk), one `perf:` JSON line.

The line before the last is a JSON object with one entry per kernel of the
path; the last line is {"ok": true, "device": {...}}.  Imports nothing of
JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.abspath(__file__))

PIX_TOL = 1e-5
MAX_FRAC_OFF = 1e-3
_PARITY_ORIGIN = (448, 512)   # (x, y) of the 128x128 parity patch
MAIN_ARGV = ["render", "--spectral",
             "--scene", os.path.join(_ROOT, "data", "scenes", "spectral.scene"),
             "--width", "1024", "--height", "1024", "--spp", "128",
             "--chunk", "128", "--relax", "2.0", "--normal-taps", "4"]


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


def _main_cfg():
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    return RenderConfig(width=1024, height=1024, spp=128, relax_omega=2.0,
                        normal_taps=4)


def _render_fns(dev, n, origin_xy=(0, 0), patch_shape=None):
    """(kernel, plain): the wrapper on CUDA tensors and the plain PyTorch
    version on the same tensors, each returning the (ph, pw, 3) mean over
    `n` samples from sample 0, with the production knobs."""
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
    knobs = dict(march_unroll=march.DEFAULT_MARCH_UNROLL,
                 lazy_miss=march.DEFAULT_LAZY_MISS,
                 regen_cadence=march.DEFAULT_REGEN_CADENCE)

    def kernel():
        return march.render_fused_spectral(
            scene, params, mats, cfg, corners, 0, n_samples=n,
            origin_xy=origin_xy, patch_shape=patch_shape, **knobs)

    def plain():
        px, py = pixel_grid(pw, ph, dev, origin_xy)
        c = trace_mega_spectral(scene, params, mats, cfg, corners, px, py,
                                0, n_samples=n, **knobs)
        inv = float(np.float32(1.0 / n))
        return torch.stack([c.x * inv, c.y * inv, c.z * inv], dim=-1)

    return kernel, plain


def _compare(label, got, want):
    """Hold the kernel's image against the plain version's; returns the
    max abs error."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    frac = float((diff > PIX_TOL).float().mean())
    max_err = float(diff.max())
    finite = bool(torch.isfinite(got).all())
    print(f"parity, {label}: fraction off by > {PIX_TOL:g}: {frac:.3e} "
          f"(bar {MAX_FRAC_OFF:g}), max abs err {max_err:.3e}, kernel mean "
          f"{float(got.mean()):.6f}, plain mean {float(want.mean()):.6f}",
          flush=True)
    if tuple(got.shape) != tuple(want.shape) or not finite \
            or frac >= MAX_FRAC_OFF:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"({label}): shape {tuple(got.shape)}, "
                             f"finite={finite}, fraction={frac}")
    return max_err


def parity(dev, card):
    """Kernel vs plain version on the same CUDA tensors: at the main path's
    own launch (the whole 1024^2 frame, 128 samples), then on a 128^2
    patch at a non-zero origin.  Returns (max abs err over both, kernel ms
    and plain ms at the main path's launch)."""
    kernel, plain = _render_fns(dev, 128)
    got = kernel()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    max_err = _compare("1024x1024 frame, 128 spp (the main path's launch)",
                       got, want)
    del got, want
    ms = _cuda_ms(kernel, reps=3, warmup=False)
    print(f"main path's launch: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"[{card}]", flush=True)

    kernel, plain = _render_fns(dev, 4, _PARITY_ORIGIN, (128, 128))
    max_err = max(max_err, _compare(
        f"128x128 patch at {_PARITY_ORIGIN}, 4 spp", kernel(), plain()))
    return max_err, ms, plain_ms


def main_path(card):
    from raymarchrenderer_tpu_torch.app import cli
    from raymarchrenderer_tpu_torch.kernels import march

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "main_path.png")
        args = cli.build_parser().parse_args(MAIN_ARGV + ["--out", out])
        march.MEGA_SPECTRAL.launches = 0
        t0 = time.perf_counter()
        img, n, render_s = cli.cmd_render(args)
        wall = time.perf_counter() - t0
        launches = march.MEGA_SPECTRAL.launches
        if launches < 1:
            raise AssertionError("the main path launched no kernel")
        if not os.path.getsize(out):
            raise AssertionError("the main path wrote no PNG")
        if tuple(img.shape) != (1024, 1024, 3):
            raise AssertionError(f"image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("the image has non-finite values")
        mean = float(img.mean())
        if not mean > 0.0:
            raise AssertionError("the image is black")
    rate = 1024 * 1024 * n / 1e6 / render_s
    print(f"main path: 1024x1024 @ {n:.0f} spp, render {render_s:.3f} s "
          f"({rate:.2f} Mpix*spp/s), wall with scene setup and PNG "
          f"{wall:.3f} s, {launches} launch(es), image mean {mean:.6f} "
          f"[{card}]", flush=True)
    return launches


def perf(dev, card):
    """The kernel and its plain version at 1024^2 with 8 samples per launch
    (the CLI's default chunk); 128 samples were timed in the parity
    phase."""
    kernel, plain = _render_fns(dev, 8)
    res = {"card": card, "kernel_ms_n8": _cuda_ms(kernel, reps=3),
           "plain_ms_n8": _cuda_ms(plain, reps=1, warmup=False)}
    for who in ("kernel", "plain"):
        res[f"{who}_mpix_spp_per_s_n8"] = 1024 * 1024 * 8 / 1e3 / res[
            f"{who}_ms_n8"]
    print("perf: " + json.dumps(res), flush=True)


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

    # 2. build
    from raymarchrenderer_tpu_torch.kernels import march
    t0 = time.perf_counter()
    march.MEGA_SPECTRAL.build()
    print(f"build: {march.MEGA_SPECTRAL.source.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{march.MEGA_SPECTRAL.build_seconds:.2f} s) [{card}]", flush=True)

    # 3. parity (its launches do not count for the main path)
    max_err, ms, plain_ms = parity(dev, card)

    # 4. main path
    launches = main_path(card)

    # 5. perf
    perf(dev, card)

    print(json.dumps({"kernels": [{
        "name": "mega_spectral", "route": "cuda",
        "source": "raymarchrenderer_tpu_torch/csrc/mega_spectral.cu",
        "replaces": "raymarchrenderer_tpu/kernels/march.py:782",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
