"""Gen-3 spectral transport pieces (`RayMarch3.glsl:251-345`).

Per-path state is one wavelength (nm, 5 nm bins, 0 == "unset") plus a
scalar power.  Materials are `ColorRange` band filters times a power
multiplier; emitters sample a wavelength from their band on first contact
and end the path; surfaces bounce into a uniform hemisphere.  The sky is a
390-830 nm emitter of power `cfg.sky_power`.

This module holds the band table, the band filter (hard, and the soft
one of spectral inverse rendering, `_apply_band_soft`) and the wavefront
transport `trace_spectral` over planes of rays, with
`render_patch_spp_spectral` (every sample of a patch in one trace, the
`train --spectral` forward), and the progressive oracle
`render_sample_spectral` / `render_spectral` (`render --spectral --impl
oracle`); the megakernel schedule is `render/mega.py`.
`trace_spectral(profile=True)` carries the per-lane work counters that
`utils.metrics.spectral_path_profile` reads.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.rng import RNGStream
from raymarchrenderer_tpu_torch.core.sampling import (
    uniform_sphere_or_hemisphere)
from raymarchrenderer_tpu_torch.core.spectral import wavelength_to_rgb
from raymarchrenderer_tpu_torch.core.vecmath import Vec3, div, vselect
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import (_march_fns,
                                                          accumulate,
                                                          get_normal, march,
                                                          spp_rays)
from raymarchrenderer_tpu_torch.scene.graph import Scene
from raymarchrenderer_tpu_torch.utils.profiling import span


class SpectralMaterials(NamedTuple):
    """SoA band-filter table, one row per scene material index.

    kind 0 = surface (band filter then hemisphere bounce); kind 1 = emitter
    (band filter then terminate, `RayMarch3.glsl:380`)."""
    min_wave: torch.Tensor   # f32[M]
    max_wave: torch.Tensor   # f32[M]
    power: torch.Tensor      # f32[M]
    kind: torch.Tensor       # i32[M]

    @staticmethod
    def from_numpy(min_wave, max_wave, power, kind,
                   device) -> "SpectralMaterials":
        """Four array-likes (e.g. the JAX package's table fields after
        `np.asarray`) -> the table on `device`."""
        f32 = [torch.as_tensor(np.array(a, np.float32), device=device)
               for a in (min_wave, max_wave, power)]
        k = torch.as_tensor(np.array(kind, np.int32), device=device)
        return SpectralMaterials(*f32, k)

    @staticmethod
    def table(rows, device) -> "SpectralMaterials":
        """rows: sequence of (min_wave, max_wave, power, kind)."""
        a = np.asarray(rows, np.float32).reshape(-1, 4)
        return SpectralMaterials.from_numpy(a[:, 0], a[:, 1], a[:, 2],
                                            a[:, 3].astype(np.int32), device)


def _lookup(mats: SpectralMaterials, mid: torch.Tensor):
    """Per-lane band-table row (min_wave, max_wave, power, kind) at
    material index `mid`, clipped to the table (a miss's -1 reads row 0),
    as the JAX package's where-chain over the rows.  A gather gives the
    same values, but its backward adds every lane's gradient into a
    handful of rows with atomics, which serialise on the card (5.3 s of a
    5.4 s spectral train step at 1024^2 x 4 samples); the where-chain's
    backward is one reduction per row."""
    z = torch.zeros(mid.shape, dtype=torch.float32, device=mid.device)
    rows = [z, z, z, torch.zeros_like(mid)]
    midc = torch.clamp(mid, 0, mats.min_wave.shape[0] - 1)
    for i in range(mats.min_wave.shape[0]):
        sel = midc == i
        rows = [torch.where(sel, col[i], r) for col, r in zip(mats, rows)]
    return tuple(rows)


def _apply_band(wl, power, u, min_w, max_w, mat_p):
    """One `mat_func_N` body (`RayMarch3.glsl:251-281`).

    unset (wl == 0): wl = floor(u*(max-min)/5)*5 + min, power *= p.
    set: outside [min, max] -> absorbed (wl := 0, terminate);
         inside -> power *= p.  Returns (wl, power, absorbed)."""
    r = div(u * (max_w - min_w), 5.0)
    sampled = torch.floor(r) * 5.0 + min_w
    unset = wl == 0.0
    outside = (wl < min_w) | (wl > max_w)
    new_wl = torch.where(unset, sampled, torch.where(outside, 0.0, wl))
    new_power = torch.where(unset | ~outside, power * mat_p, power)
    absorbed = ~unset & outside
    return new_wl, new_power, absorbed


def _apply_band_soft(wl, power, u, min_w, max_w, mat_p, edge):
    """The differentiable band filter of `train --spectral`: the unset
    draw is continuous, wl = min + u * (max - min), so d wl / d min = 1 - u
    and d wl / d max = u reach the splat; the absorb test becomes the
    boxcar transmission T = sigmoid((wl - min) / edge) *
    sigmoid((max - wl) / edge), power *= p * T, and the path continues.
    Returns (wl, power, absorbed), absorbed all false."""
    sampled = min_w + u * (max_w - min_w)
    unset = wl == 0.0
    t_soft = (torch.sigmoid((wl - min_w) / edge)
              * torch.sigmoid((max_w - wl) / edge))
    new_wl = torch.where(unset, sampled, wl)
    new_power = power * mat_p * torch.where(unset, 1.0, t_soft)
    return new_wl, new_power, torch.zeros_like(unset)


def trace_spectral(scene: Scene, params, mats: SpectralMaterials,
                   cfg: RenderConfig, eye: Vec3, d0: Vec3, px, py, sample,
                   profile: bool = False, differentiable: bool = False,
                   march_impl: str = "oracle", soft_edge: float = 8.0,
                   recorded=None, work: dict = None):
    """Gen-3 `trace` (`RayMarch3.glsl:347-444`) over planes of rays, one
    Python loop over bounces: returns (wavelength, power) per lane.

    Per bounce: march, normal, one draw u for the band filter (the hit's
    material row, or the 390-830 nm sky band on a miss), then two draws
    for the hemisphere bounce.  A path ends on an emitter hit, an
    absorption or a miss; one that runs out of bounces keeps its
    (possibly unset) wavelength, black in the splat.

    `differentiable=True` is spectral inverse rendering: the marches carry
    the implicit-function adjoint (`diff.march`), and the band filter is
    `_apply_band_soft` with edge `soft_edge` nm, so gradients reach the
    scene parameters and the band rows.  `march_impl` as for
    `integrator.trace_rgb`: "oracle", "fused" (`march_fused`) or
    "recorded" (replay `recorded`, the banks of
    `kernels.record.trace_record_fused_spectral`; differentiable only).
    `work` counts the oracle march's steps and the hits shaded, as
    `integrator.trace_rgb` does.

    `profile=True` returns (wl, power, segs, msteps, hits): per-lane int32
    counts of the segments marched (+1 per active lane and bounce), the
    map evaluations of those marches (`march(with_steps=True)`) and the
    hits shaded.  As in the JAX package, a profiled bounce marches with the
    plain `march` whatever `march_impl`; its sums equal `work`'s "march"
    and "shade"."""
    if march_impl == "recorded" and recorded is None:
        raise ValueError("march_impl='recorded' needs recorded planes")
    march_fn, _ = _march_fns(scene, params, cfg, march_impl, differentiable,
                             work)
    if differentiable:
        def band(*a):
            return _apply_band_soft(*a, edge=soft_edge)
    else:
        band = _apply_band
    shape = d0.x.shape
    dev = d0.x.device
    sky_min, sky_max = 390.0, 830.0
    sky_p = float(np.float32(cfg.sky_power))
    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    o, d = eye, d0
    wl = torch.zeros(shape, dtype=torch.float32, device=dev)
    power = ones
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    if profile:
        segs, msteps, hits = (torch.zeros(shape, dtype=torch.int32,
                                          device=dev) for _ in range(3))
    for b in range(cfg.max_bounces):
        rec_b = (None if recorded is None
                 else {k: recorded[k][b] for k in ("t", "mid", "hit")})
        if profile:
            with torch.no_grad():
                t, mid, hitm, steps = march(scene, params, cfg, o, d, ones,
                                            active, work=work,
                                            with_steps=True)
            segs = segs + active.to(torch.int32)
            msteps = msteps + steps
        else:
            t, mid, hitm = march_fn(o, d, ones, active, rec_b)
        hitp = o + d * t
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, sample, b)
        m_min, m_max, m_pow, m_kind = _lookup(mats, mid)
        u = rng.next()
        hit_active = active & hitm
        miss_active = active & ~hitm
        if work is not None:
            work["shade"] = work.get("shade", 0) + hit_active.sum()
        if profile:
            hits = hits + hit_active.to(torch.int32)
        wl_h, pw_h, absorbed = band(wl, power, u, m_min, m_max, m_pow)
        wl_s, pw_s, _ = band(wl, power, u, sky_min, sky_max, sky_p)
        new_wl = torch.where(hit_active, wl_h,
                             torch.where(miss_active, wl_s, wl))
        power = torch.where(hit_active, pw_h,
                            torch.where(miss_active, pw_s, power))
        wl = new_wl
        terminate = (hit_active & ((m_kind == 1) | absorbed)) | miss_active
        active = active & hitm & ~terminate
        new_dir = uniform_sphere_or_hemisphere(rng.next(), rng.next(), normal)
        o = vselect(active, hitp + normal * cfg.surface_offset, o)
        d = vselect(active, new_dir, d)
    if profile:
        return wl, power, segs, msteps, hits
    return wl, power


def render_patch_spp_spectral(scene: Scene, params, mats: SpectralMaterials,
                              cfg: RenderConfig, corners, origin_xy,
                              patch_shape, sample0, n_samples: int,
                              differentiable: bool = False,
                              march_impl: str = "oracle",
                              soft_edge: float = 8.0, recorded=None) -> Vec3:
    """The per-pixel SUM of the RGB splat `wavelength_to_rgb(wl) * power`
    over samples `sample0 .. sample0 + n_samples - 1` of the (ph, pw) patch
    at `origin_xy` = (x, y), traced at once in
    `integrator.render_patch_spp`'s sample-folded layout.  With
    `march_impl="recorded"` one launch of the spectral recorder
    (`kernels.record.trace_record_fused_spectral`) marches every
    (sample, bounce) first, unless the caller passes its banks as
    `recorded`; `trace_spectral` then replays the band filters and splat
    over them (the recorder in the profiler span `rmr.record`).
    `differentiable=True` is the `train --spectral` forward."""
    ph, pw = patch_shape
    S = int(n_samples)
    px, py, sample, eye, d = spp_rays(cfg, corners, origin_xy, patch_shape,
                                      sample0, S)
    if march_impl == "recorded" and recorded is None:
        from raymarchrenderer_tpu_torch.kernels.record import (
            trace_record_fused_spectral)
        with span("rmr.record"):
            recorded = trace_record_fused_spectral(
                scene, params, mats, cfg, corners, origin_xy, patch_shape,
                sample0, n_samples=S)
    wl, power = trace_spectral(scene, params, mats, cfg, eye, d, px, py,
                               sample, differentiable=differentiable,
                               march_impl=march_impl, soft_edge=soft_edge,
                               recorded=recorded)
    c = wavelength_to_rgb(wl) * power
    return Vec3(*(v.reshape(S, ph, pw).sum(0) for v in c))


def render_sample_spectral(scene: Scene, params, mats: SpectralMaterials,
                           cfg: RenderConfig, corners, sample) -> Vec3:
    """One full-frame spectral sample: `wavelength_to_rgb(wl) * power`."""
    px, py, samp, eye, d = spp_rays(cfg, corners, (0, 0),
                                    (cfg.height, cfg.width), sample, 1)
    wl, power = trace_spectral(scene, params, mats, cfg, eye, d, px, py,
                               samp)
    return wavelength_to_rgb(wl) * power


def render_spectral(scene: Scene, params, mats: SpectralMaterials,
                    cfg: RenderConfig, corners, spp: int = None, accum=None,
                    n0: float = 0.0, callback=None):
    """The oracle progressive spectral render, as `integrator.render`:
    returns (image (H, W, 3) float32, n)."""
    spp = cfg.spp if spp is None else spp
    if accum is None:
        accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                            device=corners.device)
    n = torch.tensor(float(n0), dtype=torch.float32, device=corners.device)
    with torch.no_grad():
        for s in range(int(n0), int(n0) + spp):
            color = render_sample_spectral(scene, params, mats, cfg, corners,
                                           s)
            accum, n = accumulate(accum, color, n), n + 1.0
            if callback is not None:
                callback(s, (accum, n))
    return accum, float(n)


def default_band_table(scene: Scene, device) -> SpectralMaterials:
    """Neutral gen-3 table for an RGB scene: emissive materials become
    380-780 nm power-8 emitter bands, everything else a 380-780 nm x0.8
    filter."""
    rows = [(380.0, 780.0, 8.0, 1) if scene.is_emissive(i)
            else (380.0, 780.0, 0.8, 0)
            for i in range(len(scene.materials))]
    return SpectralMaterials.table(rows, device)


def band_table(scene: Scene, device) -> SpectralMaterials:
    """The scene's authored `spectral` rows when present, else the neutral
    default."""
    if scene.spectral_rows:
        return SpectralMaterials.table(scene.spectral_rows, device)
    return default_band_table(scene, device)


def spectral_demo(device="cuda"):
    """The gen-3 hardcoded scene (`RayMarch3.glsl:132-143,251-345`):
    `sphere_on_floor` with its band table (file twin
    `data/scenes/spectral.scene`) on `device` (the card by default).
    Returns (scene, params, mats)."""
    from raymarchrenderer_tpu_torch.scene.builtin import sphere_on_floor
    scene = sphere_on_floor()
    return scene, scene.init_params(device), band_table(scene, device)
