"""The recorders: the differentiable forward's marches, in one launch.

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
mode (the TPU kernel `_record_mega`).  CUDA tensors launch the recording
entry of `csrc/mega_paths.cu` (`RECORD_PATHS`); CPU tensors run its plain
version `render.mega.trace_mega_paths(record_banks=True)`.

`trace_record_wavefront` is the same function's wavefront mode over given
ray planes (one march per bounce for every lane, the TPU kernel
`trace_record_fused(mode="wavefront")`; no CLI path reaches it): CUDA
entry `rmr_record_wavefront` of `csrc/wavefront_paths.cu`
(`RECORD_WAVEFRONT`: the RGB wavefront lane machine on a queue of rays,
each lane a ray's bounces, march steps and shadow segments in one loop),
plain version `record_wavefront_plain`.

`trace_record_fused_spectral` banks (t, mid, hit) for the spectral replay
(`render.spectral_integrator.trace_spectral(march_impl="recorded")`):
CUDA entry `rmr_record_spectral` of `csrc/mega_spectral.cu`
(`RECORD_SPECTRAL`), plain version `record_spectral_plain` over
`render.mega.trace_mega_spectral(record_banks=True)`.

Everything is detached: gradients come from the replay.  The recorders
read no sky: a missed path ends there, so env-image and SH scenes record
their geometry as any other (the env image never enters a kernel), and
the replay evaluates `Scene.sky` differentiably.
"""
from __future__ import annotations

import ctypes

import torch

from raymarchrenderer_tpu_torch.core.rng import RNGStream
from raymarchrenderer_tpu_torch.core.sampling import uniform_sphere
from raymarchrenderer_tpu_torch.core.vecmath import Vec3, vselect
from raymarchrenderer_tpu_torch.kernels.march import (
    DEFAULT_LAZY_MISS, DEFAULT_MARCH_UNROLL, DEFAULT_REGEN_CADENCE,
    RECORD_PATHS, RECORD_SPECTRAL, RECORD_WAVEFRONT, PathArgs,
    _common_fields, _leaves, _queue, paths_launch, scene_dims,
    spectral_launch, stream_args)
from raymarchrenderer_tpu_torch.kernels.scene_program import paths_buffers
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import get_normal, march
from raymarchrenderer_tpu_torch.render.mega import (trace_mega_paths,
                                                    trace_mega_spectral)
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.scene.graph import Scene
from raymarchrenderer_tpu_torch.scene.nodes import ShadeCtx

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
    args, dims, prog, data = paths_launch(
        scene, params, cfg, corners, origin_xy, ph, pw, sample0, n_samples,
        direct_light, march_unroll, False, lazy_miss, regen_cadence)
    device = corners.device
    bp = cfg.max_bounces * (3 * n_samples if args.dispersion else n_samples)
    t, mid, hit = _miss_banks(cfg, (bp, ph, pw), device)
    sd = torch.full((bp * args.n_lights, ph, pw), SD_LIT,
                    dtype=torch.float32, device=device)
    queue = _queue(device)
    RECORD_PATHS.launch(ctypes.byref(args), ctypes.byref(dims),
                        corners.contiguous().data_ptr(),
                        data.data_ptr(), prog.data_ptr(), t.data_ptr(),
                        mid.data_ptr(), hit.data_ptr(), sd.data_ptr(),
                        queue.data_ptr(), *stream_args(device))
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
    if mode == "wavefront":
        raise ValueError(
            "mode='wavefront' records given ray planes, which this entry "
            "point does not take: call trace_record_wavefront(scene, params, "
            "cfg, eye, d0, px, py, sample)")
    if mode not in ("auto", "mega"):
        raise ValueError(f"mode must be 'auto', 'mega' or 'wavefront', not "
                         f"{mode!r}")
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
    ph, pw = patch_shape
    S = int(n_samples)
    nee = bool(direct_light) and scene.n_lights > 0
    unroll, cadence, lazy = record_knobs(corners.device, nee)
    px, py = pixel_grid(pw, ph, corners.device, origin_xy)
    with torch.no_grad():
        _, banks = trace_mega_paths(
            scene, params, cfg, corners, px, py, sample0, n_samples=S,
            shade_gate=0.0, march_unroll=unroll, regen_cadence=cadence,
            lazy_miss=lazy, dispersion=cfg.separate_channels,
            direct_light=direct_light, record_banks=True, work=work)
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


def trace_record_fused_spectral(scene: Scene, params, mats,
                                cfg: RenderConfig, corners, origin_xy,
                                patch_shape, sample0, n_samples: int = 1):
    """Record every (sample, bounce) march of the spectral transport over
    the (ph, pw) patch at `origin_xy` (x, y), samples `sample0 ..
    sample0 + n_samples - 1`, in `render_patch_spp_spectral`'s
    sample-folded layout: {"t": (B, S*ph, pw) float32, "mid": int32,
    "hit": int32 (0/1)}, B = cfg.max_bounces.  A slot no path reaches
    keeps the march's miss values (t = max_dist, mid = -1, hit = 0).

    The banked geometry does not depend on the band values (uniform
    hemisphere bounces; a recording path ends only on an emitter hit or a
    miss), so one recording serves every band-table update.  The knobs
    are `record_knobs`'s: on the card unroll 32, a miss pass every 16
    steps and the lazy miss test (the spectral recorder has no NEE); on
    the CPU unroll 1, no cadence, strict."""
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if corners.device.type == "cpu":
        return record_spectral_plain(scene, params, mats, cfg, corners,
                                     origin_xy, patch_shape, sample0,
                                     n_samples)
    if corners.device.type != "cuda":
        raise ValueError(f"no route for device {corners.device}")
    ph, pw = patch_shape
    S = int(n_samples)
    with torch.no_grad():
        banks = _launch_record_spectral(scene, params, mats, cfg, corners,
                                        origin_xy, ph, pw, sample0, S,
                                        record_knobs(corners.device, False))
    return fold_banks(banks, cfg.max_bounces, S, ph, pw, False)


def _launch_record_spectral(scene, params, mats, cfg, corners, origin_xy,
                            ph, pw, sample0, S, knobs):
    unroll, cadence, lazy = knobs
    mats = type(mats)(*(m.detach() for m in mats))
    args, dims, prog, data = spectral_launch(
        scene, params, mats, cfg, corners, origin_xy, ph, pw, sample0, S,
        unroll, False, lazy, cadence)
    banks = _miss_banks(cfg, (cfg.max_bounces * S, ph, pw), corners.device)
    queue = _queue(corners.device)
    RECORD_SPECTRAL.launch(ctypes.byref(args), ctypes.byref(dims),
                           corners.contiguous().data_ptr(), data.data_ptr(),
                           prog.data_ptr(), *(b.data_ptr() for b in banks),
                           queue.data_ptr(), *stream_args(corners.device))
    return banks


def record_spectral_plain(scene: Scene, params, mats, cfg: RenderConfig,
                          corners, origin_xy, patch_shape, sample0,
                          n_samples: int = 1, work: dict = None):
    """The plain version of `trace_record_fused_spectral` on the corners'
    device, with that device's knobs: the CPU route, and on the card the
    kernel's yardstick.  `work` counts map evaluations as
    `trace_mega_spectral` does."""
    ph, pw = patch_shape
    S = int(n_samples)
    unroll, cadence, lazy = record_knobs(corners.device, False)
    px, py = pixel_grid(pw, ph, corners.device, origin_xy)
    with torch.no_grad():
        _, banks = trace_mega_spectral(
            scene, params, type(mats)(*(m.detach() for m in mats)), cfg,
            corners, px, py, sample0, n_samples=S, shade_gate=0.0,
            march_unroll=unroll, lazy_miss=lazy, regen_cadence=cadence,
            record_banks=True, work=work)
    return fold_banks(banks, cfg.max_bounces, S, ph, pw, False)


def _miss_banks(cfg: RenderConfig, shape, device):
    """t, mid and hit banks of `shape` holding the march's miss values."""
    return (torch.full(shape, cfg.max_dist, dtype=torch.float32,
                       device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


def _check_wavefront(scene: Scene, cfg: RenderConfig):
    if cfg.separate_channels:
        raise NotImplementedError(
            "dispersion recording enumerates (sample, channel) paths, a "
            "megakernel-schedule mode: use trace_record_fused")


def trace_record_wavefront(scene: Scene, params, cfg: RenderConfig,
                           eye: Vec3, d0: Vec3, px, py, sample,
                           direct_light: bool = False):
    """Record `integrator.trace_rgb`'s marches over the given (H, W) ray
    planes, one bounce at a time for every lane (the JAX package's
    `trace_record_fused(mode="wavefront")`):

        {"t": (B, H, W) float32, "mid": int32, "hit": int32 (0/1),
         "sd": (B*L, H, W) float32}          # sd only with NEE

    `eye`, `d0` are Vec3 planes, `px`, `py` the pixel coordinates and
    `sample` the RNG's sample index, per lane.  Every lane banks every
    bounce: a lane that has stopped banks the march's miss values (t =
    max_dist, mid = -1, hit = 0), and its shadow rays bank lit (3.4e38).
    CUDA planes launch `RECORD_WAVEFRONT` (a lane machine on a queue of
    the rays); CPU planes run `record_wavefront_plain`."""
    _check_wavefront(scene, cfg)
    device = d0.x.device
    if device.type == "cpu":
        return record_wavefront_plain(scene, params, cfg, eye, d0, px, py,
                                      sample, direct_light)
    if device.type != "cuda":
        raise ValueError(f"no route for device {device}")
    with torch.no_grad():
        return _launch_record_wavefront(scene, params, cfg, eye, d0, px, py,
                                        sample, direct_light)


def _launch_record_wavefront(scene, params, cfg, eye, d0, px, py, sample,
                             direct_light):
    device = d0.x.device
    nee = bool(direct_light) and scene.n_lights > 0
    for leaf in _leaves(params):
        if leaf.device != device:
            raise ValueError("scene tensors and rays are on different "
                             f"devices ({leaf.device} vs {device})")
    shape = tuple(d0.x.shape)
    n = d0.x.numel()
    B = cfg.max_bounces
    L = scene.n_lights if nee else 0
    prog, data, dims = paths_buffers(scene, params, device)
    planes = [torch.as_tensor(c, dtype=torch.float32, device=device)
              .expand(shape).contiguous() for c in (*eye, *d0)]
    planes += [torch.as_tensor(c, device=device).expand(shape)
               .to(torch.int32).contiguous()
               for c in (px, py, _u32_as_i32(sample, device))]
    banks = _miss_banks(cfg, (B, *shape), device) + (
        torch.full((B * L, *shape), SD_LIT, dtype=torch.float32,
                   device=device),)
    args = PathArgs(
        dispersion=0, nee=int(nee), n_lights=L,
        rr_start_bounce=cfg.rr_start_bounce, exit_offset=cfg.exit_offset,
        inside_offset=cfg.inside_offset, rr_min_prob=cfg.rr_min_prob,
        **_common_fields(cfg, (0, 0), 1, n, 0, 1, False, 1, 0, False))
    dims = scene_dims(dims, device, cfg.normal_taps == 0)
    queue = _queue(device)
    RECORD_WAVEFRONT.launch(ctypes.byref(args), ctypes.byref(dims), n,
                            data.data_ptr(),
                            prog.data_ptr(), *(p.data_ptr() for p in planes),
                            *(b.data_ptr() for b in banks), queue.data_ptr(),
                            *stream_args(device))
    rec = dict(zip(("t", "mid", "hit"), banks[:3]))
    if nee:
        rec["sd"] = banks[3]
    return rec


def _u32_as_i32(sample, device):
    """A uint32 sample index (number or integer tensor) as the int32 of the
    same bits."""
    s = torch.as_tensor(sample, device=device).to(torch.int64) & 0xFFFFFFFF
    return torch.where(s >= 1 << 31, s - (1 << 32), s)


def record_wavefront_plain(scene: Scene, params, cfg: RenderConfig,
                           eye: Vec3, d0: Vec3, px, py, sample,
                           direct_light: bool = False, work: dict = None):
    """The plain version of `trace_record_wavefront`: the JAX package's
    wavefront recorder in eager PyTorch, over `integrator.march`,
    `get_normal`, `Scene.shade`, `Scene.sky` and `Scene.light`, with the
    oracle's RNG keying (the shade stream at the bounce; NEE's `fork(7)`
    then `fork(101 + li)`; the roulette's `fork(13)`).  `work`, when
    given, gains the map evaluations of the marches ("march", shadow rays
    included) and the shaded hits ("shade")."""
    _check_wavefront(scene, cfg)
    nee = bool(direct_light) and scene.n_lights > 0
    L = scene.n_lights if nee else 0
    shape = d0.x.shape
    dev = d0.x.device
    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    ones3 = Vec3(ones, ones, ones)
    rec = {"t": [], "mid": [], "hit": [], "sd": []}
    with torch.no_grad():
        o, d, color = eye, d0, ones3
        inside = torch.zeros(shape, dtype=torch.float32, device=dev)
        active = torch.ones(shape, dtype=torch.bool, device=dev)
        for b in range(cfg.max_bounces):
            t, mid, hitm = march(scene, params, cfg, o, d,
                                 1.0 - 2.0 * inside, active, work=work)
            rec["t"].append(t)
            rec["mid"].append(mid)
            rec["hit"].append(hitm.to(torch.int32))
            hitp = o + d * t
            normal = get_normal(scene, params, cfg, hitp)
            rng = RNGStream(cfg.seed, px, py, sample, b)
            s = scene.shade(params, ShadeCtx(o, d, t, hitp, inside, normal,
                                             ones3, rng), mid)
            hit_active = active & hitm
            miss_active = active & ~hitm
            if work is not None:
                work["shade"] = work.get("shade", 0) + hit_active.sum()
            color = color * vselect(hit_active, s.color,
                                    vselect(miss_active,
                                            scene.sky(params, d), ones3))
            new_inside_b = s.inside.x > 0.5
            inside = torch.where(hit_active, new_inside_b.to(torch.float32),
                                 inside)
            term = (s.dir.x == 0.0) & (s.dir.y == 0.0) & (s.dir.z == 0.0)
            active_n = hit_active & ~term
            if nee:
                nrng = rng.fork(7)
                o_sh = hitp + normal * cfg.surface_offset
                for li in range(L):
                    lrng = nrng.fork(101 + li)
                    lpos, _, lradius = scene.light(params, li)
                    target = lpos + uniform_sphere(lrng.next(),
                                                   lrng.next()) * lradius
                    delta = target - hitp
                    dist_l = delta.length()
                    ldir = delta / torch.clamp(dist_l, min=1e-8)
                    sd, _, _ = march(scene, params, cfg, o_sh, ldir, ones,
                                     active_n, t_max=dist_l, work=work)
                    rec["sd"].append(torch.where(sd >= dist_l, SD_LIT, 0.0))
            if cfg.rr_start_bounce >= 0:
                pr = torch.clamp(color.max_component(), cfg.rr_min_prob, 1.0)
                u = rng.fork(13).next()
                do_rr = active_n & (b >= cfg.rr_start_bounce)
                kill = do_rr & (u >= pr)
                scale = torch.where(do_rr & ~kill, 1.0 / pr, 1.0)
                color = vselect(kill, Vec3(*(torch.zeros_like(c)
                                             for c in color)),
                                color * scale)
                active_n = active_n & ~kill
            override = ((s.hit.x != 0.0) | (s.hit.y != 0.0)
                        | (s.hit.z != 0.0))
            off = torch.where(new_inside_b, -cfg.inside_offset,
                              cfg.exit_offset)
            o_next = vselect(override, s.hit, hitp + normal * off)
            o = vselect(active_n, o_next, o)
            d = vselect(active_n, s.dir, d)
            active = active_n
    out = {k: torch.stack(v) for k, v in rec.items() if v}
    return out
