"""The fused renders: one kernel launch renders a patch.

  * `render_fused_patch` / `render_fused` — the RGB path tracer, the port
    of the JAX package's TPU kernel `render_fused_patch` in mega mode
    (`raymarchrenderer_tpu/kernels/march.py`, the `pl.pallas_call` whose
    body is `render/mega.py::trace_mega_paths`), with NEE, Russian
    roulette and dispersion: CUDA kernel `csrc/mega_paths.cu`;
  * `render_fused_spectral` — the gen-3 spectral transport, the port of
    the TPU kernel of that name (body `trace_mega_spectral`): CUDA kernel
    `csrc/mega_spectral.cu`.

Each kernel runs one thread per pixel through the lane-state machine.  The
device of the `corners` tensor picks the route: a CUDA tensor launches the
hand-written Hopper kernel, or raises; a CPU tensor runs the plain PyTorch
version (`render/mega.py`).  There is no other route and no fallback
between the two.  Env-map and SH skies, `normal_taps=0` and the TPU
kernel's wavefront mode are not ported; they raise on both routes.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from raymarchrenderer_tpu_torch.kernels.build import CudaKernel
from raymarchrenderer_tpu_torch.kernels.scene_program import (
    paths_buffers, spectral_buffers)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.kernels.scene_program import MAX_LIGHTS
from raymarchrenderer_tpu_torch.render.mega import (check_knobs,
                                                    check_paths_supported,
                                                    trace_mega_paths,
                                                    trace_mega_spectral)
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.scene.graph import Scene

# the JAX package's production knobs (kernels/march.py there): 32 march
# steps per shade pass, a miss-retire pass every 16, lazy miss test
DEFAULT_MARCH_UNROLL = 32
DEFAULT_LAZY_MISS = True
DEFAULT_REGEN_CADENCE = 16


class SpecArgs(ctypes.Structure):
    """Mirror of `struct SpecArgs` in csrc/mega_spectral.cu."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "width", "height", "ox", "oy", "pw", "ph")] + [
        ("sample0", ctypes.c_uint32), ("seed", ctypes.c_uint32)] + [
        (n, ctypes.c_int) for n in (
            "n_samples", "max_steps", "max_bounces", "march_unroll",
            "regen_cadence", "lazy_miss", "relax", "normal_taps")] + [
        (n, ctypes.c_float) for n in (
            "max_dist", "hit_eps", "step_multiply", "relax_omega",
            "one_minus_omega", "omega0", "normal_eps", "surface_offset",
            "sky_power", "inv_n")]


class PathArgs(ctypes.Structure):
    """Mirror of `struct PathArgs` in csrc/mega_paths.cu."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "width", "height", "ox", "oy", "pw", "ph")] + [
        ("sample0", ctypes.c_uint32), ("seed", ctypes.c_uint32)] + [
        (n, ctypes.c_int) for n in (
            "n_samples", "max_steps", "max_bounces", "march_unroll",
            "regen_cadence", "lazy_miss", "relax", "normal_taps",
            "dispersion", "nee", "n_lights", "rr_start_bounce")] + [
        (n, ctypes.c_float) for n in (
            "max_dist", "hit_eps", "step_multiply", "relax_omega",
            "one_minus_omega", "omega0", "normal_eps", "surface_offset",
            "exit_offset", "inside_offset", "rr_min_prob", "inv_n")]


_P = ctypes.c_void_p
MEGA_SPECTRAL = CudaKernel(
    "mega_spectral.cu", "rmr_mega_spectral",
    [ctypes.POINTER(SpecArgs), _P, _P, _P, _P, _P, ctypes.c_int])
MEGA_PATHS = CudaKernel(
    "mega_paths.cu", "rmr_mega_paths",
    [ctypes.POINTER(PathArgs), _P, _P, _P, _P, _P, ctypes.c_int])


def _inv(n_samples: int, normalize: bool) -> float:
    # float32(1/n), the rounding of the JAX kernel's weak-typed `c * inv`
    return float(np.float32(1.0 / float(n_samples))) if normalize else 1.0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _check_launch(corners, cfg, *trees):
    """The wrapper's checks before a launch: corners' type and shape, a
    ported normal estimator, and every tensor on the corners' device."""
    device = corners.device
    if corners.dtype != torch.float32 or tuple(corners.shape) != (5, 3):
        raise ValueError("corners must be a (5, 3) float32 tensor")
    if cfg.normal_taps not in (4, 6):
        raise NotImplementedError(
            f"normal_taps={cfg.normal_taps} is not ported to the kernel")
    for leaf in (leaf for tree in trees for leaf in _leaves(tree)):
        if leaf.device != device:
            raise ValueError("scene tensors and corners are on different "
                             f"devices ({leaf.device} vs {device})")


def _common_fields(cfg, origin_xy, ph, pw, sample0, n_samples, normalize,
                   march_unroll, regen_cadence, lazy_miss) -> dict:
    """The launch scalars both kernels' argument structures share."""
    return dict(
        width=cfg.width, height=cfg.height, ox=int(origin_xy[0]),
        oy=int(origin_xy[1]), pw=pw, ph=ph,
        sample0=int(sample0) & 0xFFFFFFFF, seed=int(cfg.seed) & 0xFFFFFFFF,
        n_samples=n_samples, max_steps=cfg.max_steps,
        max_bounces=cfg.max_bounces, march_unroll=march_unroll,
        regen_cadence=regen_cadence, lazy_miss=int(bool(lazy_miss)),
        relax=int(cfg.relax_omega > 1.0), normal_taps=cfg.normal_taps,
        max_dist=cfg.max_dist, hit_eps=cfg.hit_eps,
        step_multiply=cfg.step_multiply, relax_omega=cfg.relax_omega,
        one_minus_omega=float(np.float32(1.0) - np.float32(cfg.relax_omega)),
        omega0=max(cfg.relax_omega, 1.0), normal_eps=cfg.normal_eps,
        surface_offset=cfg.surface_offset, inv_n=_inv(n_samples, normalize))


def _launch(kernel, args, corners, prog, data, ph, pw):
    """Launch `kernel` on PyTorch's current stream of the corners' device;
    returns the (ph, pw, 3) float32 output."""
    device = corners.device
    corners = corners.contiguous()
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    kernel.launch(ctypes.byref(args), corners.data_ptr(), data.data_ptr(),
                  prog.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(index).cuda_stream, index)
    return out


def _launch_mega_spectral(scene, params, mats, cfg, corners, sample0,
                          n_samples, origin_xy, ph, pw, normalize,
                          lazy_miss, regen_cadence, march_unroll):
    _check_launch(corners, cfg, params["objects"], list(mats))
    prog, data = spectral_buffers(scene, params, mats, corners.device)
    args = SpecArgs(sky_power=cfg.sky_power, **_common_fields(
        cfg, origin_xy, ph, pw, sample0, n_samples, normalize, march_unroll,
        regen_cadence, lazy_miss))
    return _launch(MEGA_SPECTRAL, args, corners, prog, data, ph, pw)


def render_fused_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                          corners, sample0, n_samples: int = 1,
                          march_unroll: int = DEFAULT_MARCH_UNROLL,
                          origin_xy=(0, 0), patch_shape=None,
                          normalize: bool = True,
                          lazy_miss: bool = DEFAULT_LAZY_MISS,
                          regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """Gen-3 spectral render of a patch: (ph, pw, 3) float32, the mean over
    `n_samples` samples starting at `sample0` (or the sum with
    `normalize=False`).  `origin_xy` = (x, y) of the patch's top-left pixel
    in the `cfg.width` x `cfg.height` frame; `patch_shape` = (ph, pw),
    default the whole frame."""
    check_knobs(march_unroll, regen_cadence)
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    ph, pw = patch_shape if patch_shape is not None else (cfg.height,
                                                          cfg.width)
    if corners.device.type == "cuda":
        return _launch_mega_spectral(
            scene, params, mats, cfg, corners, sample0, n_samples, origin_xy,
            ph, pw, normalize, lazy_miss, regen_cadence, march_unroll)
    if corners.device.type != "cpu":
        raise ValueError(f"no route for device {corners.device}")
    px, py = pixel_grid(pw, ph, corners.device, origin_xy)
    c = trace_mega_spectral(scene, params, mats, cfg, corners, px, py,
                            sample0, n_samples=n_samples,
                            march_unroll=march_unroll, lazy_miss=lazy_miss,
                            regen_cadence=regen_cadence)
    inv = _inv(n_samples, normalize)
    return torch.stack([c.x * inv, c.y * inv, c.z * inv], dim=-1)


def _launch_mega_paths(scene, params, cfg, corners, origin_xy, ph, pw,
                       sample0, n_samples, direct_light, march_unroll,
                       normalize, lazy_miss, regen_cadence):
    nee = bool(direct_light) and scene.n_lights > 0
    if nee and scene.n_lights > MAX_LIGHTS:
        raise ValueError(f"the RGB kernel takes at most {MAX_LIGHTS} lights "
                         f"with direct_light, the scene has "
                         f"{scene.n_lights}")
    _check_launch(corners, cfg, params["objects"], params["materials"],
                  params["lights"], params["env"])
    prog, data = paths_buffers(scene, params, corners.device)
    args = PathArgs(
        dispersion=int(bool(cfg.separate_channels)), nee=int(nee),
        n_lights=scene.n_lights if nee else 0,
        rr_start_bounce=cfg.rr_start_bounce, exit_offset=cfg.exit_offset,
        inside_offset=cfg.inside_offset, rr_min_prob=cfg.rr_min_prob,
        **_common_fields(cfg, origin_xy, ph, pw, sample0, n_samples,
                         normalize, march_unroll, regen_cadence, lazy_miss))
    return _launch(MEGA_PATHS, args, corners, prog, data, ph, pw)


def render_fused_patch(scene: Scene, params, cfg: RenderConfig, corners,
                       origin_xy, patch_shape, sample0, n_samples: int = 1,
                       direct_light: bool = False,
                       march_unroll: int = DEFAULT_MARCH_UNROLL,
                       normalize: bool = True,
                       lazy_miss: bool = DEFAULT_LAZY_MISS,
                       regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """RGB render of a (ph, pw) patch at `origin_xy` = (x, y) of the
    `cfg.width` x `cfg.height` frame: (ph, pw, 3) float32, the mean over
    `n_samples` samples starting at `sample0` (the sum with
    `normalize=False`).  `direct_light` adds next-event estimation toward
    the scene's lights; `cfg.separate_channels` traces R, G and B as
    separate paths (dispersion); `cfg.rr_start_bounce >= 0` turns on
    Russian roulette."""
    check_knobs(march_unroll, regen_cadence)
    check_paths_supported(scene, cfg)
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    ph, pw = patch_shape
    if corners.device.type == "cuda":
        return _launch_mega_paths(
            scene, params, cfg, corners, origin_xy, ph, pw, sample0,
            n_samples, direct_light, march_unroll, normalize, lazy_miss,
            regen_cadence)
    if corners.device.type != "cpu":
        raise ValueError(f"no route for device {corners.device}")
    px, py = pixel_grid(pw, ph, corners.device, origin_xy)
    c = trace_mega_paths(scene, params, cfg, corners, px, py, sample0,
                         n_samples=n_samples, march_unroll=march_unroll,
                         dispersion=cfg.separate_channels,
                         direct_light=direct_light, lazy_miss=lazy_miss,
                         regen_cadence=regen_cadence)
    inv = _inv(n_samples, normalize)
    return torch.stack([c.x * inv, c.y * inv, c.z * inv], dim=-1)


def render_fused(scene: Scene, params, cfg: RenderConfig, corners, sample0,
                 n_samples: int = 1, direct_light: bool = False,
                 march_unroll: int = DEFAULT_MARCH_UNROLL,
                 lazy_miss: bool = DEFAULT_LAZY_MISS,
                 regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """Full-frame RGB render (the patch at origin (0, 0))."""
    return render_fused_patch(
        scene, params, cfg, corners, (0, 0), (cfg.height, cfg.width),
        sample0, n_samples=n_samples, direct_light=direct_light,
        march_unroll=march_unroll, lazy_miss=lazy_miss,
        regen_cadence=regen_cadence)


def render_progressive_fused(scene: Scene, params, cfg: RenderConfig,
                             corners, spp: int = None,
                             samples_per_launch: int = 8,
                             direct_light: bool = False, callback=None):
    """Progressive RGB render in launches of `samples_per_launch` samples,
    folded by the running mean (accum*n + chunk*k)/(n+k).
    `callback(s, (accum, n))` runs after each launch.  Returns
    (image (H, W, 3), n)."""
    spp = cfg.spp if spp is None else spp
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=corners.device)
    n = 0.0
    s = 0
    while s < spp:
        k = min(samples_per_launch, spp - s)
        chunk = render_fused(scene, params, cfg, corners, s, n_samples=k,
                             direct_light=direct_light)
        accum = (accum * n + chunk * k) / (n + k)
        n += k
        s += k
        if callback is not None:
            callback(s, (accum, n))
    return accum, n


def prepare(device, kernel: CudaKernel):
    """Build and load `kernel` (`MEGA_PATHS` or `MEGA_SPECTRAL`), when it
    renders on `device`, ahead of its first launch; returns the seconds
    this took, or None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    t0 = time.perf_counter()
    kernel.build()
    return time.perf_counter() - t0


def render_progressive_fused_spectral(scene: Scene, params, mats,
                                      cfg: RenderConfig, corners,
                                      spp: int = None,
                                      samples_per_launch: int = 8,
                                      callback=None):
    """Progressive spectral render in launches of `samples_per_launch`
    samples, folded by the running mean (accum*n + chunk*k)/(n+k).
    `callback(s, (accum, n))` runs after each launch.  Returns
    (image (H, W, 3), n)."""
    spp = cfg.spp if spp is None else spp
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=corners.device)
    n = 0.0
    s = 0
    while s < spp:
        k = min(samples_per_launch, spp - s)
        chunk = render_fused_spectral(scene, params, mats, cfg, corners, s,
                                      n_samples=k)
        accum = (accum * n + chunk * k) / (n + k)
        n += k
        s += k
        if callback is not None:
            callback(s, (accum, n))
    return accum, n
