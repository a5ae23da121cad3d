"""Headline benchmark of the port: Mpix·spp/s (and rays/s) at 1024² on one
card, the port's copy of the root `bench.py`'s `main` (which imports JAX).

Runs the flagship progressive path trace (sphere_on_floor, the gen-3
hardcoded scene of `RayMarch3.glsl:132-143`, at the reference's default
workload: 1024², 512 steps, 16 bounces; `GUI.cpp:201-208`,
`Graphics.cpp:326-329`) and prints ONE JSON line with `bench.py`'s keys.
`vs_baseline` is the ratio against the self-defined round-0 target of 1.0
Mpix·spp/s (BASELINE.md).

The same knobs, read the same way: BENCH_SIZE (1024), BENCH_SPP (128, all
in one kernel launch), BENCH_MODE=spectral|rgb (spectral), BENCH_IMPL
(auto: the CUDA kernels on a card, the oracle on the CPU; pallas or fused:
the kernels, their plain versions on the CPU; oracle: `render_sample`, the
RGB transport whatever the mode, as in `bench.py`), BENCH_RELAX (2.0),
BENCH_NORMAL_TAPS (4), the RGB-only workloads BENCH_DIRECT=1 (NEE toward
one sphere light), BENCH_ENV=1 (bench.py's 512 x 1024 gradient sky, the
deferred-sky kernel; BENCH_ENV_FILTER linear|nearest, BENCH_ENV_GATHER
mxu|exact) and BENCH_DISPERSION=1 (refused loudly in spectral mode),
BENCH_LAZY_MISS and BENCH_REGEN_CADENCE (the schedule knobs) and
BENCH_PROFILE (1: spectral mode adds the work counters and the march
occupancy, `utils.metrics`, run eagerly by the plain versions).  The
profile's `vpu_utilization_est` is left out: it divides by a TPU's VPU
peak.

Timing: one warm-up launch (the kernel's nvcc build and load before it,
`kernels.march.prepare`, out of it), then the minimum of two synchronised
launches of all `spp` samples; the oracle is the sum of `spp`
synchronised plain samples.  The metric names the platform, `cuda` or
`cpu`.

    python -m raymarchrenderer_tpu_torch bench --size 1024 --spp 128
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

BASELINE_MPIX_SPP_S = 1.0  # self-defined target (BASELINE.md)


def gradient_env() -> np.ndarray:
    """bench.py's 512 x 1024 equirect sky: a vertical gradient from (0.3,
    0.5, 1.0) at the top to (1.0, 0.6, 0.2) at the bottom."""
    v = np.linspace(0.0, 1.0, 512)[:, None, None]
    img = np.array([0.3, 0.5, 1.0]) * (1 - v) + np.array([1.0, 0.6, 0.2]) * v
    return np.broadcast_to(img, (512, 1024, 3)).astype(np.float32)


def _rgb_scene(env, use_nee: bool, use_env: bool):
    from raymarchrenderer_tpu_torch.scene.builtin import (SceneBuilder,
                                                          sphere_on_floor)
    if not (use_nee or use_env):
        return sphere_on_floor()
    b = SceneBuilder()
    m_floor = b.diffuse([0.8, 0.8, 0.8])
    m_ball = b.diffuse([0.2, 0.8, 0.3])
    b.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    b.sphere(m_ball, [0, 1, 0], 1.0)
    if use_nee:
        b.light([6, 8, -4], 60.0, 0.8)
        b.sky(0.015)
        return b.build()
    return b.build(env_image=gradient_env(),
                   env_filter=env.get("BENCH_ENV_FILTER", "linear"),
                   env_gather=env.get("BENCH_ENV_GATHER", "mxu"))


def main(env=None, device="cuda") -> dict:
    """Run the benchmark with the knobs of `env` (default `os.environ`) on
    `device`; prints the JSON line and returns it as a dict."""
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.utils.profiling import synchronize

    env = os.environ if env is None else env
    device = torch.device(device)
    size = int(env.get("BENCH_SIZE", "1024"))
    spp = int(env.get("BENCH_SPP", "128"))
    impl = env.get("BENCH_IMPL", "auto")
    relax = float(env.get("BENCH_RELAX", "2.0"))
    taps = int(env.get("BENCH_NORMAL_TAPS", "4"))
    mode = env.get("BENCH_MODE", "spectral")
    # the RGB-only workloads fail loudly in spectral mode rather than
    # silently benching the spectral headline instead
    if mode != "rgb":
        for knob in ("BENCH_DIRECT", "BENCH_ENV", "BENCH_DISPERSION"):
            if env.get(knob, "0") == "1":
                raise SystemExit(
                    f"{knob}=1 requires BENCH_MODE=rgb (it selects an RGB-"
                    f"transport workload); BENCH_MODE={mode!r} would "
                    f"silently ignore it.")
    dispersion = env.get("BENCH_DISPERSION", "0") == "1" and mode == "rgb"
    use_env = env.get("BENCH_ENV", "0") == "1" and mode == "rgb"
    use_nee = env.get("BENCH_DIRECT", "0") == "1" and mode == "rgb"
    scene = _rgb_scene(env, use_nee, use_env)
    params = scene.init_params(device)
    cfg = RenderConfig(width=size, height=size, relax_omega=relax,
                       normal_taps=taps, separate_channels=dispersion)
    corners = Camera(aspect=1.0).corner_rays_flat(device)
    use_kernels = impl in ("pallas", "fused") or (
        impl == "auto" and device.type == "cuda")
    lazy = env.get("BENCH_LAZY_MISS",
                   "1" if march.DEFAULT_LAZY_MISS else "0") == "1"
    cadence = int(env.get("BENCH_REGEN_CADENCE",
                          str(march.DEFAULT_REGEN_CADENCE)))
    if use_kernels and mode == "spectral":
        from raymarchrenderer_tpu_torch.render.spectral_integrator import (
            spectral_demo)
        scene, params, mats = spectral_demo(device)
        kernel = march.MEGA_SPECTRAL

        def step(s):
            return march.render_fused_spectral(
                scene, params, mats, cfg, corners, s, n_samples=spp,
                lazy_miss=lazy, regen_cadence=cadence)
        impl = "mega-spectral"
    elif use_kernels:
        kernel = march.MEGA_PATHS_DEFER if use_env else march.MEGA_PATHS

        def step(s):
            return march.render_fused(
                scene, params, cfg, corners, s, n_samples=spp,
                direct_light=use_nee, lazy_miss=lazy, regen_cadence=cadence)
        impl = ("mega-nee" if use_nee
                else f"env-mega-deferred-{scene.env_gather}" if use_env
                else "mega-dispersion" if dispersion else "mega")
    else:
        from raymarchrenderer_tpu_torch.render.integrator import (
            render_sample)
        kernel = None

        def step(s):
            with torch.no_grad():
                return render_sample(scene, params, cfg, corners,
                                     s).stack(-1)
        impl = "oracle"

    if kernel is not None:
        march.prepare(device, kernel)      # nvcc out of the warm-up
    out = step(0)                          # warm-up
    synchronize()
    if kernel is None:
        t0 = time.perf_counter()
        acc = torch.zeros_like(out)
        for s in range(1, spp + 1):
            acc = acc + step(s)
        synchronize()
        dt = time.perf_counter() - t0
    else:
        times = []
        for s in (1, 2):
            t0 = time.perf_counter()
            step(s * spp)
            synchronize()
            times.append(time.perf_counter() - t0)
        dt = min(times)

    mpix_spp_s = size * size * spp / dt / 1e6
    result = {
        "metric": "Mpix*spp/s @ %dx%d (impl=%s, platform=%s)" % (
            size, size, impl, device.type),
        "value": round(mpix_spp_s, 4),
        "unit": "Mpix*spp/s",
        "vs_baseline": round(mpix_spp_s / BASELINE_MPIX_SPP_S, 4),
        "wall_s": round(dt, 3),
        "spp": spp,
        "relax_omega": relax,
        "normal_taps": taps,
        "dispersion": dispersion,
    }
    # the measured work of the spectral transport: rays/s = samples/s x
    # path segments per sample, map evaluations/s likewise, from the plain
    # versions' counters (nothing estimated offline)
    if mode == "spectral" and env.get("BENCH_PROFILE", "1") == "1":
        from raymarchrenderer_tpu_torch.render.spectral_integrator import (
            band_table)
        from raymarchrenderer_tpu_torch.utils.metrics import (
            mega_occupancy_profile, spectral_path_profile)
        mats = band_table(scene, device)
        prof = spectral_path_profile(scene, params, mats, cfg, corners, 1,
                                     n_samples=4)
        samples_s = mpix_spp_s * 1e6
        result.update({
            "rays_per_s": round(samples_s * prof["segments_per_sample"], 1),
            "map_evals_per_s": round(
                samples_s * prof["map_evals_per_sample"], 1),
            **prof,
        })
        result.update(mega_occupancy_profile(
            scene, params, mats, cfg, corners, 1, n_samples=min(spp, 128),
            tiles=4))
    print(json.dumps(result), flush=True)
    return result
