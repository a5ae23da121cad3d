"""The fused kernels' wrappers: one launch renders a patch, or marches a
plane of rays.

  * `render_fused_patch` / `render_fused` — the RGB path tracer, the port
    of the JAX package's TPU kernel `render_fused_patch` in mega mode
    (`raymarchrenderer_tpu/kernels/march.py`, the `pl.pallas_call` whose
    body is `render/mega.py::trace_mega_paths`), with NEE, Russian
    roulette and dispersion: CUDA kernel `csrc/mega_paths.cu`;
  * `render_fused_spectral` — the gen-3 spectral transport, the port of
    the TPU kernel of that name (body `trace_mega_spectral`): CUDA kernel
    `csrc/mega_spectral.cu`;
  * `march_fused` — the per-ray sphere trace of the differentiable path,
    the port of the TPU kernel of that name: CUDA kernel
    `csrc/march_fused.cu`, plain version `render/integrator.py::march`.

The recorders (`RECORD_PATHS` and `RECORD_WAVEFRONT`, entries of
`csrc/mega_paths.cu`; `RECORD_SPECTRAL`, an entry of
`csrc/mega_spectral.cu`) are wrapped by `kernels/record.py`.  The megakernels
run one thread per pixel through the lane-state machine.  The device of
the input tensors (`corners`, or the ray planes) picks the route: a CUDA
tensor launches the hand-written Hopper kernel, or raises; a CPU tensor
runs the plain PyTorch version (`render/mega.py`, `render/integrator.py`).
There is no other route and no fallback between the two.  Env-map and SH
skies, `normal_taps=0` and the RGB kernel's wavefront mode are not
ported; they raise on both routes.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.kernels.build import CudaKernel
from raymarchrenderer_tpu_torch.kernels.scene_program import (
    MAX_LIGHTS, object_buffers, paths_buffers, spectral_buffers)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import march
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


class MarchArgs(ctypes.Structure):
    """Mirror of `struct MarchArgs` in csrc/march_fused.cu."""
    _fields_ = [(n, ctypes.c_int) for n in ("n", "max_steps", "relax")] + [
        (n, ctypes.c_float) for n in ("max_dist", "hit_eps", "step_multiply",
                                      "relax_omega")]


_P = ctypes.c_void_p
MEGA_SPECTRAL = CudaKernel(
    "mega_spectral.cu", "rmr_mega_spectral",
    [ctypes.POINTER(SpecArgs), _P, _P, _P, _P, _P, ctypes.c_int])
MEGA_PATHS = CudaKernel(
    "mega_paths.cu", "rmr_mega_paths",
    [ctypes.POINTER(PathArgs), _P, _P, _P, _P, _P, ctypes.c_int])
# the recording entry of the same source (one library with MEGA_PATHS):
# args, corners, data, program, then the t, mid, hit and sd banks
RECORD_PATHS = CudaKernel(
    "mega_paths.cu", "rmr_record_paths",
    [ctypes.POINTER(PathArgs), _P, _P, _P, _P, _P, _P, _P, _P,
     ctypes.c_int])
# the recording entry of mega_spectral.cu: args, corners, data, program,
# then the t, mid and hit banks
RECORD_SPECTRAL = CudaKernel(
    "mega_spectral.cu", "rmr_record_spectral",
    [ctypes.POINTER(SpecArgs), _P, _P, _P, _P, _P, _P, _P, ctypes.c_int])
# the wavefront recording entry of mega_paths.cu: args, the ray count,
# data, program, the nine ray planes, the t, mid, hit and sd banks
RECORD_WAVEFRONT = CudaKernel(
    "mega_paths.cu", "rmr_record_wavefront",
    [ctypes.POINTER(PathArgs), ctypes.c_int] + [_P] * 15 + [_P,
                                                            ctypes.c_int])
# args, program, data, the nine input planes, the three outputs
MARCH_FUSED = CudaKernel(
    "march_fused.cu", "rmr_march_fused",
    [ctypes.POINTER(MarchArgs)] + [_P] * 14 + [_P, ctypes.c_int])


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


def stream_args(device):
    """(the current CUDA stream as an int, the device index) of a CUDA
    `device`: the last two arguments of every kernel entry point."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return torch.cuda.current_stream(index).cuda_stream, index


def _launch(kernel, args, corners, prog, data, ph, pw):
    """Launch `kernel` on PyTorch's current stream of the corners' device;
    returns the (ph, pw, 3) float32 output."""
    device = corners.device
    corners = corners.contiguous()
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    kernel.launch(ctypes.byref(args), corners.data_ptr(), data.data_ptr(),
                  prog.data_ptr(), out.data_ptr(), *stream_args(device))
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


def paths_launch(scene, params, cfg, corners, origin_xy, ph, pw, sample0,
                 n_samples, direct_light, march_unroll, normalize,
                 lazy_miss, regen_cadence):
    """The checks and the (PathArgs, program, data) of a launch of
    `csrc/mega_paths.cu`, rendering or recording."""
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
    return args, prog, data


def _launch_mega_paths(scene, params, cfg, corners, origin_xy, ph, pw,
                       sample0, n_samples, direct_light, march_unroll,
                       normalize, lazy_miss, regen_cadence):
    args, prog, data = paths_launch(
        scene, params, cfg, corners, origin_xy, ph, pw, sample0, n_samples,
        direct_light, march_unroll, normalize, lazy_miss, regen_cadence)
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


def prepare(device, *kernels: CudaKernel):
    """Build and load `kernels` (`MEGA_PATHS`, `MEGA_SPECTRAL`,
    `RECORD_PATHS`, `RECORD_SPECTRAL`, `RECORD_WAVEFRONT`, `MARCH_FUSED`),
    when they run on `device`, ahead of their first launch; returns the
    seconds this took, or None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    t0 = time.perf_counter()
    for kernel in kernels:
        kernel.build()
    return time.perf_counter() - t0


def _plane(x, shape, dtype, device) -> torch.Tensor:
    """`x` (a tensor or a number) as a contiguous plane of `shape`."""
    return torch.as_tensor(x, dtype=dtype, device=device).expand(
        shape).contiguous()


def _launch_march_fused(scene, params, cfg, o, d, dist_mult, active,
                        t_max):
    device = o.x.device
    shape = torch.broadcast_shapes(*(c.shape for c in (*o, *d)))
    for leaf in _leaves(params["objects"]):
        if leaf.device != device:
            raise ValueError("scene tensors and rays are on different "
                             f"devices ({leaf.device} vs {device})")
    f32 = torch.float32
    planes = [_plane(c, shape, f32, device) for c in (*o, *d)]
    planes.append(_plane(dist_mult, shape, f32, device))
    planes.append(_plane(active, shape, torch.int32, device))
    planes.append(_plane(cfg.max_dist if t_max is None else t_max, shape,
                         f32, device))
    prog, data = object_buffers(scene, params, device)
    t = torch.empty(shape, dtype=f32, device=device)
    mid = torch.empty(shape, dtype=torch.int32, device=device)
    hit = torch.empty(shape, dtype=torch.int32, device=device)
    args = MarchArgs(n=t.numel(), max_steps=cfg.max_steps,
                     relax=int(cfg.relax_omega > 1.0), max_dist=cfg.max_dist,
                     hit_eps=cfg.hit_eps, step_multiply=cfg.step_multiply,
                     relax_omega=cfg.relax_omega)
    MARCH_FUSED.launch(ctypes.byref(args), prog.data_ptr(), data.data_ptr(),
                       *(p.data_ptr() for p in planes), t.data_ptr(),
                       mid.data_ptr(), hit.data_ptr(), *stream_args(device))
    return t, mid, hit > 0


def march_fused(scene: Scene, params, cfg: RenderConfig, o: Vec3, d: Vec3,
                dist_mult, active, t_max=None):
    """Sphere trace of every lane of the ray planes `o`, `d` (any shape):
    (t float32, material index int32, hit bool), the same contract as
    `render.integrator.march`, of which it is the fused twin.  `dist_mult`
    and `t_max` (default `cfg.max_dist`) are numbers or planes; `active`
    a bool plane.  Forward only: the outputs carry no gradient
    (`diff.march.march_diff_fused` attaches the adjoint).

    CUDA planes launch `csrc/march_fused.cu`, one thread per ray, nothing
    padded; CPU planes run `march`."""
    device = o.x.device
    with torch.no_grad():
        if device.type == "cuda":
            return _launch_march_fused(scene, params, cfg, o, d, dist_mult,
                                       active, t_max)
        if device.type != "cpu":
            raise ValueError(f"no route for device {device}")
        return march(scene, params, cfg, o, d, dist_mult, active,
                     t_max=t_max)
