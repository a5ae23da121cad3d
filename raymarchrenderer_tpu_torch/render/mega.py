"""The gen-3 spectral megakernel schedule in eager PyTorch.

This is the plain version of the CUDA kernel `csrc/mega_spectral.cu`: the
JAX package's `render/mega.py::trace_mega_spectral` as a masked lane-state
machine over an (H, W) batch of pixels.  Every lane carries its own ray,
wavelength, power, bounce, sample index and state, and one outer loop runs
until every lane has finished every sample:

  * `march_step` — one sphere-trace step of `Scene.map_dist`, relaxed
    (`cfg.relax_omega > 1`, Keinert et al. 2014) or classic, with the hit
    test every step and, unless `lazy_miss`, the miss test too;
  * `mark_misses` (`lazy_miss`) — the miss test at a pass boundary, on the
    lane's step count since its segment started (`gstep - steps`);
  * `miss_pass` — every `regen_cadence` steps inside a body: retire parked
    misses (sky band, splat, respawn) without the full shade;
  * `shade` + `regen` — once per body of `march_unroll` steps: material id,
    SDF normal, band filter, hemisphere bounce; finished paths splat
    `wavelength_to_rgb(wl) * power` and respawn at the next sample.

The first march step is peeled off before the loop, as in the JAX package:
with `lazy_miss` the positions of the pass boundaries decide which rare
lanes overshoot `max_dist`, so the peel is part of the semantics.  Every
random draw is keyed on (seed, px, py, sample, bounce, slot), so a lane's
paths do not depend on the batch it runs in.  Forward only;
`shade_gate` is fixed at 0 (an unconditional pass per body), and the
occupancy counters and record banks are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.rng import RNGStream
from raymarchrenderer_tpu_torch.core.sampling import (
    uniform_sphere_or_hemisphere)
from raymarchrenderer_tpu_torch.core.spectral import wavelength_to_rgb
from raymarchrenderer_tpu_torch.core.vecmath import Vec3, vselect
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import get_normal
from raymarchrenderer_tpu_torch.render.raygen import eye_vec, primary_rays
from raymarchrenderer_tpu_torch.render.spectral_integrator import (
    SpectralMaterials, _apply_band, _lookup)
from raymarchrenderer_tpu_torch.scene.graph import Scene

# lane states, as in the JAX package
_MARCH = 0       # sphere-tracing the current segment
_WAIT = 1        # hit found, parked until the next shade pass
_REGEN = 2       # path finished, parked until the pass banks it
_EXH = 7         # all samples done (the largest state)
_WAIT_MISS = -1  # parked miss: the sky is an emitter band, so misses shade


def check_knobs(march_unroll: int, regen_cadence: int) -> None:
    if march_unroll < 1:
        raise ValueError("march_unroll must be >= 1")
    if (regen_cadence and regen_cadence < march_unroll
            and march_unroll % regen_cadence):
        # a cadence >= unroll means "no mid-body pass"
        raise ValueError("regen_cadence must divide march_unroll")


class _Lanes:
    """The per-lane carries of the schedule (mutable; each pass rebinds
    fields to new tensors)."""

    __slots__ = ("o", "d", "t", "wl", "power", "acc", "bounce", "s_idx",
                 "state", "steps", "omega", "prev_r", "step_len", "gstep")


def trace_mega_spectral(scene: Scene, params, mats: SpectralMaterials,
                        cfg: RenderConfig, corners, px, py, sample0,
                        n_samples: int = 1, march_unroll: int = 1,
                        lazy_miss: bool = False,
                        regen_cadence: int = 0) -> Vec3:
    """Sum over `n_samples` paths per pixel of `wavelength_to_rgb(wl) *
    power`, for int32 pixel coordinates `px`, `py` (any shape, absolute
    frame coordinates) and `corners` the (5, 3) camera tensor."""
    check_knobs(march_unroll, regen_cadence)
    shape = px.shape
    device = px.device
    e = eye_vec(corners)
    eye = Vec3(e.x.expand(shape), e.y.expand(shape), e.z.expand(shape))
    s0 = int(sample0)
    sky_min, sky_max = 390.0, 830.0
    sky_p = float(np.float32(cfg.sky_power))
    relax = cfg.relax_omega > 1.0
    one_minus_omega = float(np.float32(1.0) - np.float32(cfg.relax_omega))

    def primary(s_idx):
        rng = RNGStream(cfg.seed, px, py, s0 + s_idx.long(), 1 << 20)
        return primary_rays(corners, px, py, cfg.width, cfg.height, rng)

    def seg0(st):
        # lazy mode: `steps` holds the gstep snapshot at segment start
        return st.gstep if lazy_miss else 0

    def reset_relax(st, mask):
        st.omega = torch.where(mask, cfg.relax_omega, st.omega)
        st.prev_r = torch.where(mask, 0.0, st.prev_r)
        st.step_len = torch.where(mask, 0.0, st.step_len)

    def march_step(st):
        marching = st.state == _MARCH
        p = st.o + st.d * st.t
        dist = scene.map_dist(params, p, cfg.max_dist)
        not_fail = marching
        if relax:
            fail = marching & (st.omega > 1.0) & (dist + st.prev_r
                                                  < st.step_len)
            not_fail = ~fail
        is_hit = marching & not_fail & (dist < cfg.hit_eps)
        if lazy_miss:
            st.gstep += 1
            st.state = torch.where(is_hit, _WAIT, st.state)
            still = marching & ~is_hit
        else:
            # unconditional: only marching lanes' counts are read
            st.steps = st.steps + 1
            is_miss = marching & not_fail & ~is_hit & (
                (st.t >= cfg.max_dist) | (st.steps >= cfg.max_steps))
            st.state = torch.where(is_hit, _WAIT,
                                   torch.where(is_miss, _WAIT_MISS, st.state))
            still = marching & ~is_hit & ~is_miss
        if relax:
            new_len = torch.where(fail, st.step_len * one_minus_omega,
                                  dist * st.omega)
            st.omega = torch.where(fail, 1.0, st.omega)
            st.prev_r = torch.where(still, torch.abs(dist), st.prev_r)
            st.step_len = torch.where(still, torch.abs(new_len), st.step_len)
            st.t = torch.where(still, st.t + new_len, st.t)
        else:
            st.t = torch.where(still, st.t + dist * cfg.step_multiply, st.t)

    def mark_misses(st):
        is_miss = (st.state == _MARCH) & (
            (st.t >= cfg.max_dist) | (st.gstep - st.steps >= cfg.max_steps))
        st.state = torch.where(is_miss, _WAIT_MISS, st.state)

    def shade(st):
        waiting = (st.state == _WAIT) | (st.state == _WAIT_MISS)
        hit_b = st.state == _WAIT
        hitp = st.o + st.d * st.t
        _, mid = scene.map(params, hitp, cfg.max_dist)
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, s0 + st.s_idx.long(), st.bounce)
        u = rng.next()
        m_min, m_max, m_pow, m_kind = _lookup(mats, mid)
        # one band evaluation over hit_b-selected band parameters
        b_min = torch.where(hit_b, m_min, sky_min)
        b_max = torch.where(hit_b, m_max, sky_max)
        b_pow = torch.where(hit_b, m_pow, sky_p)
        wl_n, pw_n, absorbed = _apply_band(st.wl, st.power, u,
                                           b_min, b_max, b_pow)
        st.wl = torch.where(waiting, wl_n, st.wl)
        st.power = torch.where(waiting, pw_n, st.power)
        term = (hit_b & ((m_kind == 1) | absorbed)) | ~hit_b
        st.bounce = torch.where(waiting, st.bounce + 1, st.bounce)
        done_now = term | (st.bounce >= cfg.max_bounces)
        st.state = torch.where(waiting,
                               torch.where(done_now, _REGEN, _MARCH),
                               st.state)
        new_dir = uniform_sphere_or_hemisphere(rng.next(), rng.next(),
                                               normal)
        st.o = vselect(waiting, hitp + normal * cfg.surface_offset, st.o)
        st.d = vselect(waiting, new_dir, st.d)
        st.t = torch.where(waiting, 0.0, st.t)
        st.steps = torch.where(waiting, seg0(st), st.steps)
        if relax:
            reset_relax(st, waiting)

    def regen(st):
        pending = st.state == _REGEN
        c = wavelength_to_rgb(st.wl) * st.power
        st.acc = Vec3(st.acc.x + torch.where(pending, c.x, 0.0),
                      st.acc.y + torch.where(pending, c.y, 0.0),
                      st.acc.z + torch.where(pending, c.z, 0.0))
        st.s_idx = torch.where(pending, st.s_idx + 1, st.s_idx)
        exhausted = st.s_idx >= n_samples
        st.state = torch.where(pending,
                               torch.where(exhausted, _EXH, _MARCH), st.state)
        st.o = vselect(pending, eye, st.o)
        st.d = vselect(pending, primary(st.s_idx), st.d)
        st.wl = torch.where(pending, 0.0, st.wl)
        st.power = torch.where(pending, 1.0, st.power)
        st.t = torch.where(pending, 0.0, st.t)
        st.steps = torch.where(pending, seg0(st), st.steps)
        st.bounce = torch.where(pending, 0, st.bounce)
        if relax:
            reset_relax(st, pending)

    def miss_pass(st):
        """Retire only parked misses: sky band, splat, respawn; the same
        RNG slot `shade` would draw."""
        missing = st.state == _WAIT_MISS
        rng = RNGStream(cfg.seed, px, py, s0 + st.s_idx.long(), st.bounce)
        wl_s, pw_s, _ = _apply_band(st.wl, st.power, rng.next(),
                                    sky_min, sky_max, sky_p)
        st.wl = torch.where(missing, wl_s, st.wl)
        st.power = torch.where(missing, pw_s, st.power)
        st.bounce = torch.where(missing, st.bounce + 1, st.bounce)
        st.state = torch.where(missing, _REGEN, st.state)
        regen(st)

    def body(st):
        if regen_cadence and regen_cadence < march_unroll:
            n_sub = march_unroll // regen_cadence
            for c in range(n_sub):
                for _ in range(regen_cadence):
                    march_step(st)
                if c < n_sub - 1:
                    if lazy_miss:
                        mark_misses(st)
                    miss_pass(st)
        else:
            for _ in range(march_unroll):
                march_step(st)
        if lazy_miss:
            mark_misses(st)
        shade(st)
        regen(st)

    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    izero = torch.zeros(shape, dtype=torch.int32, device=device)
    st = _Lanes()
    st.o, st.d, st.t = eye, primary(izero), zero
    st.wl, st.power = zero, torch.ones_like(zero)
    st.acc = Vec3(zero, zero, zero)
    st.bounce, st.s_idx, st.state, st.steps = izero, izero, izero, izero
    st.omega = torch.full_like(zero, max(cfg.relax_omega, 1.0))
    st.prev_r, st.step_len = zero, zero
    st.gstep = 0
    march_step(st)                      # the peeled first step
    while bool((st.state < _EXH).any()):
        body(st)
    return st.acc
