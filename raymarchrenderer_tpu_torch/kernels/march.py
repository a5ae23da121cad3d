"""The fused kernels' wrappers: one launch renders a patch, or marches a
plane of rays.

  * `render_fused_patch` / `render_fused` — the RGB path tracer, the port
    of the JAX package's TPU kernel `render_fused_patch`
    (`raymarchrenderer_tpu/kernels/march.py`, the `pl.pallas_call` whose
    body `_tile_kernel` runs `render/mega.py::trace_mega_paths` or, in
    wavefront mode, `render/integrator.py::trace_rgb` per sample), with
    NEE, Russian roulette, dispersion and every sky:
      - mega mode, constant or SH sky: CUDA kernel `csrc/mega_paths.cu`
        (`MEGA_PATHS`; the SH sky evaluated in-kernel);
      - mega mode, env-image sky (`defer_sky`): `MEGA_PATHS_DEFER`, an
        entry of the same source whose lanes bank each path's miss event
        (throughput, packed equirect (u, v)) instead of evaluating the
        sky, then the composite `color + sum_k thr_k * sky_uv(u_k, v_k)`
        in plain PyTorch (it is plain XLA in the JAX package);
      - wavefront mode (`mode="wavefront"`): `csrc/wavefront_paths.cu`
        (`WAVEFRONT_PATHS`), a lane machine that runs `trace_rgb` over
        the samples of each pixel, march step by march step, on a pixel
        queue; with an env image it banks (throughput, direction) per
        path slot and the composite evaluates `Scene.sky`;
  * `render_fused_spectral` — the gen-3 spectral transport, the port of
    the TPU kernel of that name: mega mode (body `trace_mega_spectral`)
    is `csrc/mega_spectral.cu`, wavefront mode (`trace_spectral` per
    sample) `csrc/wavefront_spectral.cu` (`WAVEFRONT_SPECTRAL`), a lane
    machine on the pixel queue like the RGB one;
  * `march_fused` — the per-ray sphere trace of the differentiable path,
    the port of the TPU kernel of that name: CUDA kernel
    `csrc/march_fused.cu` (a persistent grid on a queue of rays, its
    counter from `_queue`), plain version `render/integrator.py::march`.

The recorders (`RECORD_PATHS`, an entry of `csrc/mega_paths.cu`;
`RECORD_SPECTRAL`, an entry of `csrc/mega_spectral.cu`;
`RECORD_WAVEFRONT`, an entry of `csrc/wavefront_paths.cu`) are wrapped by
`kernels/record.py`.  The megakernels run the lane-state machine, one
thread per pixel or, for the deferred sky and the recorders, a persistent
grid on the pixel queue; the wavefront recorder runs the RGB wavefront
lane machine on a queue of rays.  The device of
the input tensors (`corners`, or the ray planes) picks the route: a CUDA
tensor launches the hand-written Hopper kernel, or raises; a CPU tensor
runs the plain PyTorch version (`render/mega.py`, `render/integrator.py`,
`wavefront_paths_plain`, `wavefront_spectral_plain`).  There is no other
route and no fallback between the two.  `normal_taps=0` (the exact
normal) takes each source's exact-normal instantiation, which the entry
point picks on the host (`grad_map` in csrc/scene_map.cuh).
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.vecmath import Vec3, div
from raymarchrenderer_tpu_torch.diff.march import _leaves
from raymarchrenderer_tpu_torch.kernels.build import CudaKernel
from raymarchrenderer_tpu_torch.kernels import scene_program
from raymarchrenderer_tpu_torch.kernels.scene_program import (
    SKY_DEFER, object_buffers, paths_buffers, sky_kind, spectral_buffers)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import (march, spp_rays,
                                                          trace_rgb)
from raymarchrenderer_tpu_torch.render.mega import (check_knobs,
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


class SceneDims(ctypes.Structure):
    """Mirror of `struct SceneDims` in csrc/scene_map.cuh."""
    _fields_ = [(n, ctypes.c_int) for n in ("n_words", "n_floats",
                                            "n_stored", "n_regs")]


# the shared memory a block may opt in to on an H100 (227 KiB), where the
# device properties do not say
_SMEM_OPTIN = 232448


def scene_dims(dims, device, exact: bool) -> SceneDims:
    """The `SceneDims` of a launch on the CUDA `device` from the buffers'
    sizes `dims`.  Raises, with the size, when the block's shared memory
    cannot hold the scene's program, data and every thread's register
    slots."""
    need = scene_program.shared_bytes(dims, exact)
    limit = getattr(torch.cuda.get_device_properties(device),
                    "shared_memory_per_block_optin", _SMEM_OPTIN)
    if need > limit:
        raise ValueError(
            f"the scene needs {need} bytes of shared memory per block "
            f"({dims[0]} program words, {dims[1]} data floats, and "
            f"{scene_program.BLOCK_THREADS} threads' register slots: "
            f"{dims[3] if exact else dims[2]} "
            f"{'registers' if exact else 'stored values'} each), more than "
            f"the {limit} bytes a block of this card can have")
    return SceneDims(*dims)


_P = ctypes.c_void_p
_D = ctypes.POINTER(SceneDims)
# Every entry takes the launch scalars, then the scene's `SceneDims`, ...,
# and ends with the stream and the device index; the persistent entries
# (the RGB megakernel's deferred sky and recorder, the spectral recorder,
# both wavefront kernels and the wavefront recorder, `march_fused`) take
# their queue's counter (`_queue`) before the stream.
# args, dims, corners, data, program, the output
MEGA_SPECTRAL = CudaKernel(
    "mega_spectral.cu", "rmr_mega_spectral",
    [ctypes.POINTER(SpecArgs), _D, _P, _P, _P, _P, _P, ctypes.c_int])
# args, dims, corners, data, program, the output, the sky kind
# (scene_program.SKY_CONST or SKY_SH: the kernel's sky policy)
MEGA_PATHS = CudaKernel(
    "mega_paths.cu", "rmr_mega_paths",
    [ctypes.POINTER(PathArgs), _D, _P, _P, _P, _P, ctypes.c_int, _P,
     ctypes.c_int])
# the deferred-sky entry of mega_paths.cu: args, dims, corners, data,
# program, the raw-sum output, then the thr_r, thr_g, thr_b and packed-uv
# banks, the queue
MEGA_PATHS_DEFER = CudaKernel(
    "mega_paths.cu", "rmr_mega_paths_defer",
    [ctypes.POINTER(PathArgs), _D] + [_P] * 9 + [_P, ctypes.c_int])
# the RGB wavefront kernel: args, dims, the sky kind, corners, data,
# program, the output, then the thr_r, thr_g, thr_b, dir_x, dir_y, dir_z
# banks (null without an env image), the queue
WAVEFRONT_PATHS = CudaKernel(
    "wavefront_paths.cu", "rmr_wavefront_paths",
    [ctypes.POINTER(PathArgs), _D, ctypes.c_int] + [_P] * 11 + [
        _P, ctypes.c_int])
# the spectral wavefront kernel: args, dims, corners, data, program, the
# output, the queue
WAVEFRONT_SPECTRAL = CudaKernel(
    "wavefront_spectral.cu", "rmr_wavefront_spectral",
    [ctypes.POINTER(SpecArgs), _D, _P, _P, _P, _P, _P, _P, ctypes.c_int])
# the recording entry of the same source (one library with MEGA_PATHS):
# args, dims, corners, data, program, then the t, mid, hit and sd banks,
# the queue
RECORD_PATHS = CudaKernel(
    "mega_paths.cu", "rmr_record_paths",
    [ctypes.POINTER(PathArgs), _D] + [_P] * 8 + [_P, ctypes.c_int])
# the recording entry of mega_spectral.cu: args, dims, corners, data,
# program, then the t, mid and hit banks, the queue
RECORD_SPECTRAL = CudaKernel(
    "mega_spectral.cu", "rmr_record_spectral",
    [ctypes.POINTER(SpecArgs), _D, _P, _P, _P, _P, _P, _P, _P, _P,
     ctypes.c_int])
# the wavefront recording entry of wavefront_paths.cu (one library with
# WAVEFRONT_PATHS): args, dims, the ray count, data, program, the nine ray
# planes, the t, mid, hit and sd banks, the ray queue
RECORD_WAVEFRONT = CudaKernel(
    "wavefront_paths.cu", "rmr_record_wavefront",
    [ctypes.POINTER(PathArgs), _D, ctypes.c_int] + [_P] * 16 + [
        _P, ctypes.c_int])
# args, dims, program, data, the nine input planes, the three outputs, the
# ray queue's counter
MARCH_FUSED = CudaKernel(
    "march_fused.cu", "rmr_march_fused",
    [ctypes.POINTER(MarchArgs), _D] + [_P] * 15 + [_P, ctypes.c_int])


def _inv(n_samples: int, normalize: bool) -> float:
    # float32(1/n), the rounding of the JAX kernel's weak-typed `c * inv`
    return float(np.float32(1.0 / float(n_samples))) if normalize else 1.0


def _check_launch(corners, cfg, *trees):
    """The wrapper's checks before a launch: corners' type and shape, a
    normal estimator the kernels have (0, 4 or 6 taps), and every tensor
    on the corners' device."""
    device = corners.device
    if corners.dtype != torch.float32 or tuple(corners.shape) != (5, 3):
        raise ValueError("corners must be a (5, 3) float32 tensor")
    if cfg.normal_taps not in (0, 4, 6):
        raise ValueError(f"normal_taps must be 0, 4 or 6, not "
                         f"{cfg.normal_taps}")
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


def _queue(device):
    """The queue's counter of one persistent launch (pixels, or the rays of
    `march_fused`): a zeroed int32 on the device, new for every launch."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _launch(kernel, args, dims, corners, prog, data, ph, pw, *queue):
    """Launch `kernel` on PyTorch's current stream of the corners' device
    (a persistent kernel with its `queue`); returns the (ph, pw, 3)
    float32 output."""
    device = corners.device
    corners = corners.contiguous()
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    kernel.launch(ctypes.byref(args), ctypes.byref(dims), corners.data_ptr(),
                  data.data_ptr(), prog.data_ptr(), out.data_ptr(),
                  *(q.data_ptr() for q in queue), *stream_args(device))
    return out


def _launch_mega_spectral(scene, params, mats, cfg, corners, sample0,
                          n_samples, origin_xy, ph, pw, normalize,
                          lazy_miss, regen_cadence, march_unroll):
    _check_launch(corners, cfg, params["objects"], list(mats))
    prog, data, dims = spectral_buffers(scene, params, mats, corners.device)
    args = SpecArgs(sky_power=cfg.sky_power, **_common_fields(
        cfg, origin_xy, ph, pw, sample0, n_samples, normalize, march_unroll,
        regen_cadence, lazy_miss))
    dims = scene_dims(dims, corners.device, cfg.normal_taps == 0)
    return _launch(MEGA_SPECTRAL, args, dims, corners, prog, data, ph, pw)


def _launch_wavefront_spectral(scene, params, mats, cfg, corners, sample0,
                               n_samples, origin_xy, ph, pw, normalize):
    _check_launch(corners, cfg, params["objects"], list(mats))
    prog, data, dims = spectral_buffers(scene, params, mats, corners.device)
    args = SpecArgs(sky_power=cfg.sky_power, **_common_fields(
        cfg, origin_xy, ph, pw, sample0, n_samples, normalize, 1, 0, False))
    dims = scene_dims(dims, corners.device, cfg.normal_taps == 0)
    return _launch(WAVEFRONT_SPECTRAL, args, dims, corners, prog, data, ph,
                   pw, _queue(corners.device))


def wavefront_spectral_plain(scene: Scene, params, mats, cfg: RenderConfig,
                             corners, sample0, n_samples, origin_xy, ph, pw,
                             normalize: bool = True, work: dict = None):
    """The plain version of the spectral wavefront kernel: for each sample
    the primary ray, `trace_spectral`'s bounce loop and the splat
    `wavelength_to_rgb(wl) * power`, summed sample by sample (the JAX
    kernel's `mode="wavefront"` body); (ph, pw, 3).  `work` counts the map
    evaluations as `trace_spectral` does."""
    from raymarchrenderer_tpu_torch.core.spectral import wavelength_to_rgb
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        trace_spectral)
    acc = Vec3(*(torch.zeros((ph, pw), dtype=torch.float32,
                             device=corners.device) for _ in range(3)))
    with torch.no_grad():
        for k in range(n_samples):
            px, py, samp, eye, d = spp_rays(cfg, corners, origin_xy,
                                            (ph, pw), int(sample0) + k, 1)
            wl, power = trace_spectral(scene, params, mats, cfg, eye, d, px,
                                       py, samp, work=work)
            acc = acc + wavelength_to_rgb(wl) * power
    inv = _inv(n_samples, normalize)
    return torch.stack([acc.x * inv, acc.y * inv, acc.z * inv], dim=-1)


def render_fused_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                          corners, sample0, n_samples: int = 1,
                          march_unroll: int = DEFAULT_MARCH_UNROLL,
                          origin_xy=(0, 0), patch_shape=None,
                          normalize: bool = True,
                          lazy_miss: bool = DEFAULT_LAZY_MISS,
                          regen_cadence: int = DEFAULT_REGEN_CADENCE,
                          mode: str = "mega"):
    """Gen-3 spectral render of a patch: (ph, pw, 3) float32, the mean over
    `n_samples` samples starting at `sample0` (or the sum with
    `normalize=False`).  `origin_xy` = (x, y) of the patch's top-left pixel
    in the `cfg.width` x `cfg.height` frame; `patch_shape` = (ph, pw),
    default the whole frame.  `mode="mega"` runs the spectral megakernel
    (per-lane bounces with in-loop sample regeneration);
    `mode="wavefront"` loops `trace_spectral` over the samples (the
    schedule knobs do not apply)."""
    check_knobs(march_unroll, regen_cadence)
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if mode not in ("mega", "wavefront"):
        raise ValueError(f"mode must be 'mega' or 'wavefront', not {mode!r}")
    ph, pw = patch_shape if patch_shape is not None else (cfg.height,
                                                          cfg.width)
    if corners.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no route for device {corners.device}")
    cuda = corners.device.type == "cuda"
    if mode == "wavefront":
        if cuda:
            return _launch_wavefront_spectral(
                scene, params, mats, cfg, corners, sample0, n_samples,
                origin_xy, ph, pw, normalize)
        return wavefront_spectral_plain(scene, params, mats, cfg, corners,
                                        sample0, n_samples, origin_xy, ph,
                                        pw, normalize)
    if cuda:
        return _launch_mega_spectral(
            scene, params, mats, cfg, corners, sample0, n_samples, origin_xy,
            ph, pw, normalize, lazy_miss, regen_cadence, march_unroll)
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
    """The checks and the (PathArgs, SceneDims, program, data) of a launch
    of `csrc/mega_paths.cu` or `csrc/wavefront_paths.cu`, rendering or
    recording."""
    nee = bool(direct_light) and scene.n_lights > 0
    _check_launch(corners, cfg, params["objects"], params["materials"],
                  params["lights"], params["env"])
    prog, data, dims = paths_buffers(scene, params, corners.device)
    args = PathArgs(
        dispersion=int(bool(cfg.separate_channels)), nee=int(nee),
        n_lights=scene.n_lights if nee else 0,
        rr_start_bounce=cfg.rr_start_bounce, exit_offset=cfg.exit_offset,
        inside_offset=cfg.inside_offset, rr_min_prob=cfg.rr_min_prob,
        **_common_fields(cfg, origin_xy, ph, pw, sample0, n_samples,
                         normalize, march_unroll, regen_cadence, lazy_miss))
    return args, scene_dims(dims, corners.device, cfg.normal_taps == 0), \
        prog, data


def _launch_mega_paths(scene, params, cfg, corners, origin_xy, ph, pw,
                       sample0, n_samples, direct_light, march_unroll,
                       normalize, lazy_miss, regen_cadence):
    args, dims, prog, data = paths_launch(
        scene, params, cfg, corners, origin_xy, ph, pw, sample0, n_samples,
        direct_light, march_unroll, normalize, lazy_miss, regen_cadence)
    device = corners.device
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    MEGA_PATHS.launch(ctypes.byref(args), ctypes.byref(dims),
                      corners.contiguous().data_ptr(), data.data_ptr(),
                      prog.data_ptr(), out.data_ptr(), sky_kind(scene),
                      *stream_args(device))
    return out


def _banks(dtypes, k, ph, pw, device):
    """Zero-filled (k, ph, pw) banks, one of each dtype in `dtypes`."""
    return [torch.zeros((k, ph, pw), dtype=dt, device=device)
            for dt in dtypes]


def _launch_mega_defer(scene, params, cfg, corners, origin_xy, ph, pw,
                       sample0, n_samples, direct_light, march_unroll,
                       lazy_miss, regen_cadence):
    """One launch of the deferred-sky megakernel: the raw (ph, pw, 3) sum
    without the sky, and the (thr_r, thr_g, thr_b, uv) banks, each
    (n_paths, ph, pw), zero-filled first (thr = 0 marks a slot whose path
    ended on a hit)."""
    args, dims, prog, data = paths_launch(
        scene, params, cfg, corners, origin_xy, ph, pw, sample0, n_samples,
        direct_light, march_unroll, False, lazy_miss, regen_cadence)
    device = corners.device
    n_paths = n_samples * (3 if cfg.separate_channels else 1)
    banks = _banks((torch.float32,) * 3 + (torch.int32,), n_paths, ph, pw,
                   device)
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    queue = _queue(device)
    MEGA_PATHS_DEFER.launch(ctypes.byref(args), ctypes.byref(dims),
                            corners.contiguous().data_ptr(), data.data_ptr(),
                            prog.data_ptr(), out.data_ptr(),
                            *(b.data_ptr() for b in banks),
                            queue.data_ptr(), *stream_args(device))
    return out, banks


def _mega_defer_plain(scene, params, cfg, corners, origin_xy, ph, pw,
                      sample0, n_samples, direct_light, march_unroll,
                      lazy_miss, regen_cadence):
    """The plain version of `_launch_mega_defer` (the same returns)."""
    px, py = pixel_grid(pw, ph, corners.device, origin_xy)
    c, banks = trace_mega_paths(
        scene, params, cfg, corners, px, py, sample0, n_samples=n_samples,
        march_unroll=march_unroll, dispersion=cfg.separate_channels,
        direct_light=direct_light, defer_sky=True, lazy_miss=lazy_miss,
        regen_cadence=regen_cadence)
    return c.stack(-1), list(banks)


def _composite(color, thr, sky: Vec3):
    """color (ph, pw, 3) + the sum over the K slots of thr_k * sky_k."""
    return torch.stack([color[..., j] + (t * c).sum(0)
                        for j, (t, c) in enumerate(zip(thr, sky))], dim=-1)


def composite_uv(scene: Scene, params, color, banks):
    """The mega deferred sky's composite: color (ph, pw, 3) + the sum over
    the K slots of thr_k * sky_uv(u_k, v_k), (u, v) unpacked at the
    centres of their 16-bit bins, (x + 0.5) / 65536 (the JAX package's
    composite, plain XLA there)."""
    uvp = banks[3]
    u = (((uvp >> 16) & 0xFFFF).to(torch.float32) + 0.5) / 65536.0
    v = ((uvp & 0xFFFF).to(torch.float32) + 0.5) / 65536.0
    return _composite(color, banks[:3], scene.sky_uv(params, u, v))


def composite_dir(scene: Scene, params, color, banks):
    """The wavefront deferred sky's composite: color + the sum over the K
    slots of thr_k * Scene.sky(dir_k) (the exact atan2)."""
    return _composite(color, banks[:3], scene.sky(params, Vec3(*banks[3:])))


def _launch_wavefront_paths(scene, params, cfg, corners, origin_xy, ph, pw,
                            sample0, n_slots, direct_light=False,
                            normalize=True, defer_k=0):
    """One launch of the RGB wavefront kernel.  Without an env image:
    the (ph, pw, 3) mean (sum) over `n_slots` samples.  With one
    (`defer_k` > 0, the bank depth): `n_slots` = n_valid path slots are
    traced from path `sample0`, and the return is (raw sum, the six
    (defer_k, ph, pw) banks thr_r, thr_g, thr_b, dir_x, dir_y, dir_z,
    zero-filled first)."""
    args, dims, prog, data = paths_launch(
        scene, params, cfg, corners, origin_xy, ph, pw, sample0, n_slots,
        direct_light, 1, normalize and not defer_k, False, 0)
    device = corners.device
    banks = _banks((torch.float32,) * 6, defer_k, ph, pw, device) \
        if defer_k else []
    ptrs = [b.data_ptr() for b in banks] or [None] * 6
    out = torch.empty((ph, pw, 3), dtype=torch.float32, device=device)
    queue = _queue(device)
    WAVEFRONT_PATHS.launch(ctypes.byref(args), ctypes.byref(dims),
                           sky_kind(scene),
                           corners.contiguous().data_ptr(), data.data_ptr(),
                           prog.data_ptr(), out.data_ptr(), *ptrs,
                           queue.data_ptr(), *stream_args(device))
    return (out, banks) if defer_k else out


def wavefront_paths_plain(scene: Scene, params, cfg: RenderConfig, corners,
                          origin_xy, ph, pw, sample0, n_slots,
                          direct_light=False, normalize=True, defer_k=0,
                          work: dict = None):
    """The plain version of `_launch_wavefront_paths` (the same returns):
    the JAX kernel's `mode="wavefront"` body, `trace_rgb` sample by sample
    (as `render_patch`; with dispersion its three channel paths), summed
    in order.  With an env image each path slot k < n_slots is one path
    of the (sample, channel) counter from `sample0` (channel ci of sample
    s shares s's primary ray and draws stream s * 4 + ci + 1), traced by
    `trace_rgb(defer_sky=True)`; its miss event goes to bank slot k and
    the slots from n_slots on stay zero.  `work` counts the map
    evaluations as `trace_rgb` does."""
    device = corners.device
    z = torch.zeros((ph, pw), dtype=torch.float32, device=device)
    acc = Vec3(z, z, z)
    banks = _banks((torch.float32,) * 6, defer_k, ph, pw, device)
    disp = cfg.separate_channels

    def trace(samp, sid, ci, defer):
        px, py, _, eye, d = spp_rays(cfg, corners, origin_xy, (ph, pw), samp,
                                     1)
        ch = [torch.full((ph, pw), 1.0 if ci is None else float(ci == j),
                         dtype=torch.float32, device=device)
              for j in range(3)]
        return trace_rgb(scene, params, cfg, eye, d, px, py, sid, Vec3(*ch),
                         direct_light, defer_sky=defer, work=work)

    with torch.no_grad():
        for k in range(n_slots):
            s = int(sample0) + k
            if not defer_k:
                if disp:
                    c = Vec3(z, z, z)
                    for ci in range(3):
                        c = c + trace(s, s * 4 + ci + 1, ci, False)
                else:
                    c = trace(s, s, None, False)
                acc = acc + c
                continue
            samp, ci = divmod(s, 3) if disp else (s, None)
            c, mt, md = trace(samp, samp * 4 + ci + 1 if disp else s, ci,
                              True)
            acc = acc + c
            for bank, v in zip(banks, (*mt, *md)):
                bank[k] = v
    if defer_k:
        return acc.stack(-1), banks
    inv = _inv(n_slots, normalize)
    return torch.stack([acc.x * inv, acc.y * inv, acc.z * inv], dim=-1)


def _render_deferred(scene, params, cfg, corners, origin_xy, ph, pw,
                     sample0, n_samples, direct_light, mode, march_unroll,
                     normalize, lazy_miss, regen_cadence):
    """An env-image render: bank-depth chunks of launches, each followed by
    its composite, summed, then divided once by `n_samples` (unless
    `normalize=False`).  The chunk counter runs over paths, 3 per sample
    with dispersion.  Mega mode: K = min(32 // unit, n) * unit paths (whole
    samples), with one tail launch at its own depth for the remainder;
    wavefront mode: K = min(8, n_paths) slots, the last chunk's trailing
    slots masked by n_valid."""
    unit = 3 if cfg.separate_channels else 1
    n_paths = n_samples * unit
    s0 = int(sample0) * unit
    cuda = corners.device.type == "cuda"
    if mode == "mega":
        k_bank = min(32 // unit, n_samples) * unit
        n_full, rem = divmod(n_paths, k_bank)
        chunks = [(s0 + c * k_bank, k_bank) for c in range(n_full)]
        if rem:
            chunks.append((s0 + n_full * k_bank, rem))
        launch = _launch_mega_defer if cuda else _mega_defer_plain
        total = None
        for start, k in chunks:
            color, banks = launch(scene, params, cfg, corners, origin_xy,
                                  ph, pw, start // unit, k // unit,
                                  direct_light, march_unroll, lazy_miss,
                                  regen_cadence)
            part = composite_uv(scene, params, color, banks)
            total = part if total is None else total + part
    else:
        k_bank = min(8, n_paths)
        launch = _launch_wavefront_paths if cuda else wavefront_paths_plain
        total = None
        for c in range(-(-n_paths // k_bank)):
            n_valid = min(k_bank, n_paths - c * k_bank)
            color, banks = launch(scene, params, cfg, corners, origin_xy,
                                  ph, pw, s0 + c * k_bank, n_valid,
                                  direct_light, False, k_bank)
            part = composite_dir(scene, params, color, banks)
            total = part if total is None else total + part
    return div(total, float(n_samples)) if normalize else total


def render_fused_patch(scene: Scene, params, cfg: RenderConfig, corners,
                       origin_xy, patch_shape, sample0, n_samples: int = 1,
                       direct_light: bool = False, mode: str = "auto",
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
    Russian roulette.  The sky is the scene's: constant, SH (evaluated in
    the kernel) or an env image (`scene.has_env_map`: the deferred sky,
    chunked and composited by `_render_deferred`).

    `mode`: "mega" (and "auto", as in the JAX package) is the megakernel
    schedule; "wavefront" traces each sample's path to its end, sample
    after sample (the schedule knobs do not apply)."""
    check_knobs(march_unroll, regen_cadence)
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if mode == "auto":
        mode = "mega"
    if mode not in ("mega", "wavefront"):
        raise ValueError(f"mode must be 'auto', 'mega' or 'wavefront', not "
                         f"{mode!r}")
    if corners.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no route for device {corners.device}")
    cuda = corners.device.type == "cuda"
    ph, pw = patch_shape
    if sky_kind(scene) == SKY_DEFER:
        return _render_deferred(scene, params, cfg, corners, origin_xy, ph,
                                pw, sample0, n_samples, direct_light, mode,
                                march_unroll, normalize, lazy_miss,
                                regen_cadence)
    if mode == "wavefront":
        fn = _launch_wavefront_paths if cuda else wavefront_paths_plain
        return fn(scene, params, cfg, corners, origin_xy, ph, pw, sample0,
                  n_samples, direct_light, normalize)
    if cuda:
        return _launch_mega_paths(
            scene, params, cfg, corners, origin_xy, ph, pw, sample0,
            n_samples, direct_light, march_unroll, normalize, lazy_miss,
            regen_cadence)
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
                 mode: str = "auto",
                 march_unroll: int = DEFAULT_MARCH_UNROLL,
                 lazy_miss: bool = DEFAULT_LAZY_MISS,
                 regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """Full-frame RGB render (the patch at origin (0, 0))."""
    return render_fused_patch(
        scene, params, cfg, corners, (0, 0), (cfg.height, cfg.width),
        sample0, n_samples=n_samples, direct_light=direct_light, mode=mode,
        march_unroll=march_unroll, lazy_miss=lazy_miss,
        regen_cadence=regen_cadence)


def render_sample_fused(scene: Scene, params, cfg: RenderConfig, corners,
                        sample, direct_light: bool = False):
    """One full-frame sample through the RGB kernel, a drop-in for
    `render.integrator.render_sample` (returns the stacked (H, W, 3))."""
    return render_fused(scene, params, cfg, corners, sample, n_samples=1,
                        direct_light=direct_light)


def _resume_state(cfg: RenderConfig, corners, accum, n0: float):
    """The accumulator (zeros, or `accum` on the corners' device) and the
    running count of a progressive render resumed at sample `n0`."""
    if accum is None:
        accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                            device=corners.device)
    else:
        accum = torch.as_tensor(accum, dtype=torch.float32).to(
            corners.device)
    return accum, float(n0)


def render_progressive_fused(scene: Scene, params, cfg: RenderConfig,
                             corners, spp: int = None,
                             samples_per_launch: int = 8,
                             direct_light: bool = False, accum=None,
                             n0: float = 0.0, callback=None):
    """Progressive RGB render of `spp` samples from sample `int(n0)`, in
    launches of `samples_per_launch` samples, each folded into the running
    mean (accum*n + chunk*k)/(n+k); resumable from a checkpoint's
    (`accum`, `n0`).  `callback(s, (accum, n))` runs after each launch, `s`
    the next sample index.  Returns (image (H, W, 3), n)."""
    spp = cfg.spp if spp is None else spp
    accum, n = _resume_state(cfg, corners, accum, n0)
    s = int(n0)
    while s < int(n0) + spp:
        k = min(samples_per_launch, int(n0) + spp - s)
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
                                      accum=None, n0: float = 0.0,
                                      callback=None):
    """Progressive spectral render, resumable, as
    `render_progressive_fused`.  Returns (image (H, W, 3), n)."""
    spp = cfg.spp if spp is None else spp
    accum, n = _resume_state(cfg, corners, accum, n0)
    s = int(n0)
    while s < int(n0) + spp:
        k = min(samples_per_launch, int(n0) + spp - s)
        chunk = render_fused_spectral(scene, params, mats, cfg, corners, s,
                                      n_samples=k)
        accum = (accum * n + chunk * k) / (n + k)
        n += k
        s += k
        if callback is not None:
            callback(s, (accum, n))
    return accum, n


def prepare(device, *kernels: CudaKernel):
    """Build and load `kernels` (`MEGA_PATHS`, `MEGA_PATHS_DEFER`,
    `WAVEFRONT_PATHS`, `MEGA_SPECTRAL`, `WAVEFRONT_SPECTRAL`,
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
    prog, data, dims = object_buffers(scene, params, device)
    t = torch.empty(shape, dtype=f32, device=device)
    mid = torch.empty(shape, dtype=torch.int32, device=device)
    hit = torch.empty(shape, dtype=torch.int32, device=device)
    args = MarchArgs(n=t.numel(), max_steps=cfg.max_steps,
                     relax=int(cfg.relax_omega > 1.0), max_dist=cfg.max_dist,
                     hit_eps=cfg.hit_eps, step_multiply=cfg.step_multiply,
                     relax_omega=cfg.relax_omega)
    dims = scene_dims(dims, device, False)
    queue = _queue(device)
    MARCH_FUSED.launch(ctypes.byref(args), ctypes.byref(dims),
                       prog.data_ptr(), data.data_ptr(),
                       *(p.data_ptr() for p in planes), t.data_ptr(),
                       mid.data_ptr(), hit.data_ptr(), queue.data_ptr(),
                       *stream_args(device))
    return t, mid, hit > 0


def march_fused(scene: Scene, params, cfg: RenderConfig, o: Vec3, d: Vec3,
                dist_mult, active, t_max=None):
    """Sphere trace of every lane of the ray planes `o`, `d` (any shape):
    (t float32, material index int32, hit bool), the same contract as
    `render.integrator.march`, of which it is the fused twin.  `dist_mult`
    and `t_max` (default `cfg.max_dist`) are numbers or planes; `active`
    a bool plane.  Forward only: the outputs carry no gradient
    (`diff.march.march_diff_fused` attaches the adjoint).

    CUDA planes launch `csrc/march_fused.cu`, a persistent grid whose
    lanes take the rays from a queue, nothing padded; CPU planes run
    `march`."""
    device = o.x.device
    with torch.no_grad():
        if device.type == "cuda":
            return _launch_march_fused(scene, params, cfg, o, d, dist_mult,
                                       active, t_max)
        if device.type != "cpu":
            raise ValueError(f"no route for device {device}")
        return march(scene, params, cfg, o, d, dist_mult, active,
                     t_max=t_max)
