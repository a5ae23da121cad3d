"""The fused gen-3 spectral render: one kernel launch renders a patch.

`render_fused_spectral` is the port of the JAX package's TPU kernel of the
same name (`raymarchrenderer_tpu/kernels/march.py`, the `pl.pallas_call`
whose body is `render/mega.py::trace_mega_spectral`).  The device of the
`corners` tensor picks the route:

  * a CUDA tensor launches the hand-written Hopper kernel
    `csrc/mega_spectral.cu` (one thread per pixel running the lane-state
    machine), or raises;
  * a CPU tensor runs the plain PyTorch version
    (`render.mega.trace_mega_spectral`).

There is no other route and no fallback between the two.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from raymarchrenderer_tpu_torch.kernels.build import CudaKernel
from raymarchrenderer_tpu_torch.kernels.scene_program import scene_buffers
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.mega import (check_knobs,
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


_P = ctypes.c_void_p
MEGA_SPECTRAL = CudaKernel(
    "mega_spectral.cu", "rmr_mega_spectral",
    [ctypes.POINTER(SpecArgs), _P, _P, _P, _P, _P, ctypes.c_int])


def _inv(n_samples: int, normalize: bool) -> float:
    # float32(1/n), the rounding of the JAX kernel's weak-typed `c * inv`
    return float(np.float32(1.0 / float(n_samples))) if normalize else 1.0


def _launch_mega_spectral(scene, params, mats, cfg, corners, sample0,
                          n_samples, origin_xy, ph, pw, normalize,
                          lazy_miss, regen_cadence, march_unroll):
    device = corners.device
    if corners.dtype != torch.float32 or tuple(corners.shape) != (5, 3):
        raise ValueError("corners must be a (5, 3) float32 tensor")
    if cfg.normal_taps not in (4, 6):
        raise NotImplementedError(
            f"normal_taps={cfg.normal_taps} is not ported to the kernel")
    for t in (mats.min_wave, mats.max_wave, mats.power, mats.kind):
        if t.device != device:
            raise ValueError("band table and corners are on different "
                             f"devices ({t.device} vs {device})")
    for leaf in (leaf for obj in params["objects"] for leaf in obj):
        if leaf.device != device:
            raise ValueError("scene parameters and corners are on "
                             f"different devices ({leaf.device} vs {device})")
    prog, data = scene_buffers(scene, params, mats, device)
    corners = corners.contiguous()
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    relax = cfg.relax_omega > 1.0
    args = SpecArgs(
        width=cfg.width, height=cfg.height, ox=int(origin_xy[0]),
        oy=int(origin_xy[1]), pw=pw, ph=ph,
        sample0=int(sample0) & 0xFFFFFFFF, seed=int(cfg.seed) & 0xFFFFFFFF,
        n_samples=n_samples, max_steps=cfg.max_steps,
        max_bounces=cfg.max_bounces, march_unroll=march_unroll,
        regen_cadence=regen_cadence, lazy_miss=int(bool(lazy_miss)),
        relax=int(relax), normal_taps=cfg.normal_taps,
        max_dist=cfg.max_dist, hit_eps=cfg.hit_eps,
        step_multiply=cfg.step_multiply, relax_omega=cfg.relax_omega,
        one_minus_omega=float(np.float32(1.0) - np.float32(cfg.relax_omega)),
        omega0=max(cfg.relax_omega, 1.0), normal_eps=cfg.normal_eps,
        surface_offset=cfg.surface_offset, sky_power=cfg.sky_power,
        inv_n=_inv(n_samples, normalize))
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = torch.cuda.current_stream(index).cuda_stream
    MEGA_SPECTRAL.launch(ctypes.byref(args), corners.data_ptr(),
                         data.data_ptr(), prog.data_ptr(), out.data_ptr(),
                         stream, index)
    return out


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


def prepare(device):
    """Build and load the kernel that renders on `device` ahead of its
    first launch; returns the seconds this took, or None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    t0 = time.perf_counter()
    MEGA_SPECTRAL.build()
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
