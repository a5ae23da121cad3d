"""The megakernel schedules in eager PyTorch: gen-3 spectral and RGB.

These are the plain versions of the CUDA kernels `csrc/mega_spectral.cu`
(`trace_mega_spectral`) and `csrc/mega_paths.cu` (`trace_mega_paths`): the
JAX package's `render/mega.py` functions of the same names as masked
lane-state machines over an (H, W) batch of pixels.  Every lane carries
its own ray, path state, bounce, sample index and state, and one outer
loop runs until every lane has finished every sample.  The spectral one:

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
`shade_gate` is fixed at 0 (an unconditional pass per body; the gate is
bitwise-invariant in the JAX package).  `with_occupancy` counts, per lane,
the march steps it marched and the steps it ran
(`utils.metrics.mega_occupancy_profile`).

`trace_mega_paths` runs the gen-1 RGB transport the same way, with the
scene's material graphs (`Scene.shade`), Russian roulette, dispersion and
next-event estimation, whose shadow rays march as extra segments of the
same loop (`_SHADOW` -> `_SH_LIT` / `_SH_OCC`, banked by `resolve`).
With `record_banks` it is the plain version of the recording megakernel:
it banks every shaded hit's march residuals (t, material, hit) and every
resolved shadow ray's visibility, the planes the differentiable replay
reads in place of its marches (`kernels/record.py`);
`trace_mega_spectral(record_banks=True)` is the spectral recorder's plain
version in the same way.  The RGB schedule's sky is the scene's
(`Scene.sky`: constant or SH) at each miss, or, with `defer_sky` (env-map
scenes), a miss parks as `_WAIT_MISS` and the regeneration banks its
throughput and packed equirect (u, v) at the path's slot for the
composite outside (`kernels/march.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.rng import RNGStream
from raymarchrenderer_tpu_torch.core.sampling import (
    uniform_sphere, uniform_sphere_or_hemisphere)
from raymarchrenderer_tpu_torch.core.spectral import wavelength_to_rgb
from raymarchrenderer_tpu_torch.core.vecmath import (Vec3, atan2_poly, div,
                                                     vselect)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import get_normal
from raymarchrenderer_tpu_torch.render.raygen import eye_vec, primary_rays
from raymarchrenderer_tpu_torch.render.spectral_integrator import (
    SpectralMaterials, _apply_band, _lookup)
from raymarchrenderer_tpu_torch.scene.graph import Scene
from raymarchrenderer_tpu_torch.scene.nodes import ShadeCtx

_PI = 3.14159265358979323846

# lane states, as in the JAX package
_MARCH = 0       # sphere-tracing the current segment
_WAIT = 1        # hit found, parked until the next shade pass
_REGEN = 2       # path finished, parked until the pass banks it
_SHADOW = 4      # NEE: marching the shadow ray toward the current light
_SH_LIT = 5      # NEE: shadow ray reached the light (or its budget)
_SH_OCC = 6      # NEE: shadow ray hit something first
_EXH = 7         # all samples done (the largest state)
_WAIT_MISS = -1  # parked miss: spectral, the sky is an emitter band, so
#                 misses shade; RGB with defer_sky, banked at regen


def _bank_write(bank, slot, mask, value) -> None:
    """bank[slot[l], l] = value[l] for every lane l set in `mask`, the bank
    viewed as (slots, lanes); each (slot, lane) has at most one writer."""
    flat = bank.view(bank.shape[0], -1)
    lanes = mask.reshape(-1).nonzero().squeeze(1)
    flat[slot.reshape(-1)[lanes].long(), lanes] = value.reshape(-1)[lanes]


def _count(work, key: str, mask) -> None:
    """Add the lanes set in `mask` to work[key] (a device tensor, so
    counting adds no host sync)."""
    if work is not None:
        work[key] = work.get(key, 0) + mask.sum()


def _count_bodies(work, state) -> None:
    """Add one to work["lane_bodies"] (an int32 plane of the lanes' shape)
    at every lane that runs this body, i.e. has not reached EXH."""
    if work is not None:
        live = (state < _EXH).to(torch.int32)
        work["lane_bodies"] = work.get("lane_bodies", 0) + live


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
                 "state", "steps", "omega", "prev_r", "step_len", "gstep",
                 "m_cnt", "tot_cnt")


def trace_mega_spectral(scene: Scene, params, mats: SpectralMaterials,
                        cfg: RenderConfig, corners, px, py, sample0,
                        n_samples: int = 1, march_unroll: int = 1,
                        lazy_miss: bool = False,
                        regen_cadence: int = 0, record_banks: bool = False,
                        with_occupancy: bool = False,
                        work: dict = None) -> Vec3:
    """Sum over `n_samples` paths per pixel of `wavelength_to_rgb(wl) *
    power`, for int32 pixel coordinates `px`, `py` (any shape, absolute
    frame coordinates) and `corners` the (5, 3) camera tensor.

    `work`, when given, is a dict that gains the counts of the map
    evaluations a one-lane-per-thread kernel makes on these inputs:
    "march" (one per marching lane and step) and "shade" (hits shaded,
    one material lookup plus `normal_taps` evaluations each, 2 for the
    exact gradient of `normal_taps=0`), and "lane_bodies", an int32 plane
    of `px`'s shape: the bodies each lane runs before EXH.

    `record_banks`: returns (sum, banks), the plain version of the
    spectral recorder: t float32, mid int32 and hit int32, each
    (max_bounces * n_samples, *shape), written at each shaded hit's slot
    bounce * n_samples + sample; unreached slots keep the march's miss
    values (t = max_dist, mid = -1, hit = 0).  A recording path ends only
    on an emitter hit or a miss, not on an absorption, because the soft
    band filter of the replay (`_apply_band_soft`) never absorbs.

    `with_occupancy`: returns (sum, m_cnt, tot_cnt), int32 planes of
    `px`'s shape: every `march_step` call (the peeled first one included)
    adds one to `tot_cnt` of every lane and to `m_cnt` of the lanes in
    `_MARCH`; their ratio is the schedule's masked-lane occupancy.  A
    render-only counter, as in the JAX package: it refuses
    `record_banks`."""
    check_knobs(march_unroll, regen_cadence)
    if record_banks and with_occupancy:
        raise ValueError("record_banks keeps the strict miss schedule "
                         "(occupancy is a render-only knob)")
    shape = px.shape
    device = px.device
    e = eye_vec(corners)
    eye = Vec3(e.x.expand(shape), e.y.expand(shape), e.z.expand(shape))
    s0 = int(sample0)
    sky_min, sky_max = 390.0, 830.0
    sky_p = float(np.float32(cfg.sky_power))
    relax = cfg.relax_omega > 1.0
    one_minus_omega = float(np.float32(1.0) - np.float32(cfg.relax_omega))
    banks = ()
    if record_banks:
        bs = cfg.max_bounces * n_samples
        banks = (torch.full((bs, *shape), cfg.max_dist, dtype=torch.float32,
                            device=device),
                 torch.full((bs, *shape), -1, dtype=torch.int32,
                            device=device),
                 torch.zeros((bs, *shape), dtype=torch.int32, device=device))

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
        _count(work, "march", marching)
        if with_occupancy:
            st.m_cnt = st.m_cnt + marching.to(torch.int32)
            st.tot_cnt = st.tot_cnt + 1
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
        _count(work, "shade", hit_b)
        hitp = st.o + st.d * st.t
        _, mid = scene.map(params, hitp, cfg.max_dist)
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, s0 + st.s_idx.long(), st.bounce)
        u = rng.next()
        m_min, m_max, m_pow, m_kind = _lookup(mats, mid)
        if record_banks:
            slot = st.bounce * n_samples + st.s_idx
            _bank_write(banks[0], slot, hit_b, st.t)
            _bank_write(banks[1], slot, hit_b, mid)
            _bank_write(banks[2], slot, hit_b, torch.ones_like(mid))
        # one band evaluation over hit_b-selected band parameters
        b_min = torch.where(hit_b, m_min, sky_min)
        b_max = torch.where(hit_b, m_max, sky_max)
        b_pow = torch.where(hit_b, m_pow, sky_p)
        wl_n, pw_n, absorbed = _apply_band(st.wl, st.power, u,
                                           b_min, b_max, b_pow)
        st.wl = torch.where(waiting, wl_n, st.wl)
        st.power = torch.where(waiting, pw_n, st.power)
        if record_banks:
            absorbed = torch.zeros_like(absorbed)
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
        _count_bodies(work, st.state)
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
    st.m_cnt, st.tot_cnt = izero, izero
    march_step(st)                      # the peeled first step
    while bool((st.state < _EXH).any()):
        body(st)
    if with_occupancy:
        return st.acc, st.m_cnt, st.tot_cnt
    return (st.acc, banks) if record_banks else st.acc


class _PathLanes:
    """The per-lane carries of the RGB schedule; the NEE fields are used
    only with `direct_light` on a scene with lights."""

    __slots__ = ("o", "d", "t", "thr", "acc", "inside", "bounce", "s_idx",
                 "state", "steps", "omega", "prev_r", "step_len", "gstep",
                 "sh_o", "sh_d", "seg_tmax", "contrib", "extra", "resume",
                 "li", "sh_store")


def pack_uv(d: Vec3) -> torch.Tensor:
    """The deferred sky's bank value of a miss direction `d`: its equirect
    (u, v) quantised to 16 bits each and packed (u << 16) | v (int32), the
    JAX package's quantisation op for op: atan2_poly, phi wrapped to
    [0, 2 pi), u = phi / 2 pi, v = 1 - (y * 0.5 + 0.5), truncated to int32
    after * 65536, clipped to [0, 65535].  The composite reads it back at
    the bin centres (`kernels.march.composite_uv`)."""
    two_pi = 6.283185307179586
    phi = atan2_poly(d.z, d.x)
    phi = torch.where(phi < 0, phi + two_pi, phi)
    uu = div(phi, two_pi)
    vv = 1.0 - (d.y * 0.5 + 0.5)
    ui = torch.clamp((uu * 65536.0).to(torch.int32), 0, 65535)
    vi = torch.clamp((vv * 65536.0).to(torch.int32), 0, 65535)
    return (ui << 16) | vi


def trace_mega_paths(scene: Scene, params, cfg: RenderConfig, corners,
                     px, py, sample0, channels: Vec3 = None,
                     n_samples: int = 1, march_unroll: int = 1,
                     dispersion: bool = False, direct_light: bool = False,
                     record_banks: bool = False, defer_sky: bool = False,
                     lazy_miss: bool = False,
                     regen_cadence: int = 0, work: dict = None) -> Vec3:
    """Sum over `n_samples` samples per pixel of the gen-1 RGB path
    radiance, for int32 pixel coordinates `px`, `py` (absolute frame
    coordinates) and `corners` the (5, 3) camera tensor.  `channels` is
    the path's colour mask (default white).

    `dispersion` (`separateChannels`, `RayMarch.glsl:580-598`): the lane's
    path counter runs over (sample, channel) pairs; channel ci of sample s
    shares s's primary ray and draws the shade stream s*4 + ci + 1, and
    each channel banks on its own.  `direct_light`: next-event estimation
    toward every light of the scene, the shadow rays marching as segments
    of the same loop.  `cfg.rr_start_bounce >= 0` turns on Russian
    roulette, drawn from `rng.fork(13)` at the lane's bounce.  `work` is
    as for `trace_mega_spectral` (shadow-ray steps count as "march").

    `defer_sky` (env-map scenes): returns (sum, banks) with the sky left
    out of the sum.  A missed path parks as `_WAIT_MISS`; the next
    regeneration banks its throughput and its direction's equirect (u, v),
    quantised to 16 bits each and packed (u << 16) | v, at the path's
    slot of the banks (thr_r, thr_g, thr_b float32 and uv int32, each
    (P, *shape), P = n_paths), and, with NEE, adds the path's NEE
    radiance to the sum.  A slot whose path ended on a hit keeps thr = 0.

    `record_banks`: returns (sum, banks), the banks stacked over slots,
    P = n_paths paths per bounce: t float32, mid int32 and hit int32, each
    (B * P, *shape), written at each shaded hit's slot bounce * P + path;
    with NEE also sd float32 (B * P * L, *shape), written at each resolved
    shadow ray's slot ((bounce - 1) * P + path) * L + light, 3.4e38 when
    lit and 0 when occluded.  Unreached slots keep the march's miss values
    (t = max_dist, mid = -1, hit = 0, sd lit).  A recording run evaluates
    no sky (a miss ends the path, so no banked value depends on it)."""
    if record_banks and defer_sky:
        raise ValueError("record_banks and defer_sky are exclusive modes")
    check_knobs(march_unroll, regen_cadence)
    shape = px.shape
    device = px.device
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    izero = torch.zeros(shape, dtype=torch.int32, device=device)
    zeros3 = Vec3(zero, zero, zero)
    e = eye_vec(corners)
    eye = Vec3(e.x.expand(shape), e.y.expand(shape), e.z.expand(shape))
    if channels is None:
        one = torch.ones(shape, dtype=torch.float32, device=device)
        channels = Vec3(one, one, one)
    s0 = int(sample0)
    n_paths = n_samples * 3 if dispersion else n_samples
    relax = cfg.relax_omega > 1.0
    nee = direct_light and scene.n_lights > 0
    one_minus_omega = float(np.float32(1.0) - np.float32(cfg.relax_omega))
    n_l = scene.n_lights if nee else 0
    banks = ()
    if record_banks:
        bp = cfg.max_bounces * n_paths
        banks = (torch.full((bp, *shape), cfg.max_dist, dtype=torch.float32,
                            device=device),
                 torch.full((bp, *shape), -1, dtype=torch.int32,
                            device=device),
                 torch.zeros((bp, *shape), dtype=torch.int32, device=device))
        if n_l:
            banks += (torch.full((bp * n_l, *shape), 3.4e38,
                                 dtype=torch.float32, device=device),)
    if defer_sky:
        banks = tuple(torch.zeros((n_paths, *shape), dtype=torch.float32,
                                  device=device) for _ in range(3)) + (
            torch.zeros((n_paths, *shape), dtype=torch.int32,
                        device=device),)
    # a missed bounce ray parks here (a shadow ray's miss is _SH_LIT)
    miss_state = _WAIT_MISS if defer_sky else _REGEN

    if dispersion:
        def lane_streams(s_idx):
            """(primary stream, shade stream) of path counter s_idx."""
            samp = s0 + torch.div(s_idx, 3, rounding_mode="floor").long()
            return samp, samp * 4 + (s_idx % 3).long() + 1

        def lane_channels(s_idx):
            ci = s_idx % 3
            return Vec3(*((ci == k).to(torch.float32) for k in range(3)))
    else:
        def lane_streams(s_idx):
            s = s0 + s_idx.long()
            return s, s

        def lane_channels(s_idx):
            return channels

    def primary(s_idx):
        rng = RNGStream(cfg.seed, px, py, lane_streams(s_idx)[0], 1 << 20)
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
        if nee:
            # the lane's active segment: its bounce ray or the shadow ray
            shadow = st.state == _SHADOW
            seg = marching | shadow
            o_seg = vselect(shadow, st.sh_o, st.o)
            d_seg = vselect(shadow, st.sh_d, st.d)
            dist_mult = torch.where(shadow, 1.0, 1.0 - 2.0 * st.inside)
            tmax = st.seg_tmax
        else:
            seg = marching
            o_seg, d_seg = st.o, st.d
            dist_mult = 1.0 - 2.0 * st.inside
            tmax = cfg.max_dist
        _count(work, "march", seg)
        p = o_seg + d_seg * st.t
        dist = scene.map_dist(params, p, cfg.max_dist) * dist_mult
        not_fail = seg
        if relax:
            fail = seg & (st.omega > 1.0) & (dist + st.prev_r < st.step_len)
            not_fail = ~fail
        is_hit = seg & not_fail & (dist < cfg.hit_eps)
        if lazy_miss:
            st.gstep += 1
            if nee:
                # a shadow ray past its light must not occlude: mark_misses
                # parks it as lit at the pass boundary
                is_hit = is_hit & (~shadow | (st.t < tmax))
                st.state = torch.where(
                    is_hit, torch.where(shadow, _SH_OCC, _WAIT), st.state)
            else:
                st.state = torch.where(is_hit, _WAIT, st.state)
            still = seg & ~is_hit
        else:
            # unconditional: only marching lanes' counts are read
            st.steps = st.steps + 1
            is_miss = seg & not_fail & ~is_hit & (
                (st.t >= tmax) | (st.steps >= cfg.max_steps))
            sky_miss(st, is_miss & ~shadow if nee else is_miss)
            if nee:
                # an exhausted shadow ray counts as lit
                st.state = torch.where(
                    is_hit, torch.where(shadow, _SH_OCC, _WAIT),
                    torch.where(is_miss,
                                torch.where(shadow, _SH_LIT, miss_state),
                                st.state))
            else:
                st.state = torch.where(
                    is_hit, _WAIT, torch.where(is_miss, miss_state,
                                               st.state))
            still = seg & ~is_hit & ~is_miss
        if relax:
            new_len = torch.where(fail, st.step_len * one_minus_omega,
                                  dist * st.omega)
            st.omega = torch.where(fail, 1.0, st.omega)
            st.prev_r = torch.where(still, torch.abs(dist), st.prev_r)
            st.step_len = torch.where(still, torch.abs(new_len), st.step_len)
            st.t = torch.where(still, st.t + new_len, st.t)
        else:
            st.t = torch.where(still, st.t + dist * cfg.step_multiply, st.t)

    def sky_miss(st, bounce_miss):
        """A missed bounce ray's throughput times the sky (not for a
        recording, whose banks no sky reaches, nor with `defer_sky`)."""
        if not (record_banks or defer_sky):
            st.thr = vselect(bounce_miss, st.thr * scene.sky(params, st.d),
                             st.thr)

    def mark_misses(st):
        """The lazy miss test at a pass boundary, with the miss-time sky
        multiply the strict step would have made."""
        if nee:
            shadow = st.state == _SHADOW
            seg = (st.state == _MARCH) | shadow
            tmax = st.seg_tmax
        else:
            seg = st.state == _MARCH
            tmax = cfg.max_dist
        is_miss = seg & ((st.t >= tmax)
                         | (st.gstep - st.steps >= cfg.max_steps))
        sky_miss(st, is_miss & ~shadow if nee else is_miss)
        if nee:
            st.state = torch.where(
                is_miss, torch.where(shadow, _SH_LIT, miss_state), st.state)
        else:
            st.state = torch.where(is_miss, miss_state, st.state)

    def light_segment(lix, nrng, hitp, normal, thr):
        """(direction, distance, contribution) of the shadow ray toward a
        jittered point of light `lix` (`integrator._direct_light`)."""
        lrng = nrng.fork(101 + lix)
        lpos, lpower, lradius = scene.light(params, lix)
        target = lpos + uniform_sphere(lrng.next(), lrng.next()) * lradius
        delta = target - hitp
        dist_l = delta.length()
        ldir = delta / torch.clamp(dist_l, min=1e-8)
        cos_t = torch.clamp(ldir.dot(normal), min=0.0)
        fall = lpower / torch.clamp(dist_l * dist_l, min=1e-8)
        return ldir, dist_l, thr * div(cos_t * fall, _PI)

    def shade(st):
        waiting = st.state == _WAIT
        _count(work, "shade", waiting)
        hitp = st.o + st.d * st.t
        _, mid = scene.map(params, hitp, cfg.max_dist)
        if record_banks:
            slot = st.bounce * n_paths + st.s_idx
            _bank_write(banks[0], slot, waiting, st.t)
            _bank_write(banks[1], slot, waiting, mid)
            _bank_write(banks[2], slot, waiting, torch.ones_like(mid))
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, lane_streams(st.s_idx)[1],
                        st.bounce)
        ctx = ShadeCtx(st.o, st.d, st.t, hitp, st.inside, normal,
                       lane_channels(st.s_idx), rng)
        s = scene.shade(params, ctx, mid)
        thr = vselect(waiting, st.thr * s.color, st.thr)
        new_inside_b = s.inside.x > 0.5
        st.inside = torch.where(waiting, new_inside_b.to(torch.float32),
                                st.inside)
        term = (s.dir.x == 0.0) & (s.dir.y == 0.0) & (s.dir.z == 0.0)
        bounce = torch.where(waiting, st.bounce + 1, st.bounce)
        done_now = term | (bounce >= cfg.max_bounces)
        # NEE uses the throughput before the roulette scales or kills it
        pre_rr_thr = thr
        if cfg.rr_start_bounce >= 0:
            # the roulette runs on every continuing hit, the last bounce
            # included (gated on ~term, not ~done_now), at the lane's
            # bounce before the increment
            p = torch.clamp(thr.max_component(), cfg.rr_min_prob, 1.0)
            u = rng.fork(13).next()
            do_rr = waiting & ~term & (st.bounce >= cfg.rr_start_bounce)
            kill = do_rr & (u >= p)
            scale = torch.where(do_rr & ~kill, 1.0 / p, 1.0)
            thr = vselect(kill, zeros3, thr * scale)
            done_now = done_now | kill
        st.thr = thr
        st.bounce = bounce
        st.state = torch.where(
            waiting, torch.where(done_now, _REGEN, _MARCH), st.state)
        override = (s.hit.x != 0.0) | (s.hit.y != 0.0) | (s.hit.z != 0.0)
        off = torch.where(new_inside_b, -cfg.inside_offset, cfg.exit_offset)
        o_next = vselect(override, s.hit, hitp + normal * off)
        st.o = vselect(waiting, o_next, st.o)
        st.d = vselect(waiting, s.dir, st.d)
        st.t = torch.where(waiting, 0.0, st.t)
        st.steps = torch.where(waiting, seg0(st), st.steps)
        if relax:
            reset_relax(st, waiting)
        if not nee:
            return
        # every non-terminated hit detours through light 0's shadow ray;
        # the other lights' segments wait in the stash
        do_nee = waiting & ~term
        nrng = rng.fork(7)
        per_light = [light_segment(lix, nrng, hitp, normal, pre_rr_thr)
                     for lix in range(scene.n_lights)]
        d0, tm0, c0 = per_light[0]
        st.resume = torch.where(do_nee, st.state, st.resume)
        st.sh_store = [
            (vselect(do_nee, dl, od), torch.where(do_nee, tl, otm),
             vselect(do_nee, cl, oc))
            for (dl, tl, cl), (od, otm, oc) in zip(per_light[1:],
                                                   st.sh_store)]
        st.state = torch.where(do_nee, _SHADOW, st.state)
        st.li = torch.where(do_nee, 0, st.li)
        st.sh_o = vselect(do_nee, hitp + normal * cfg.surface_offset, st.sh_o)
        st.sh_d = vselect(do_nee, d0, st.sh_d)
        st.seg_tmax = torch.where(do_nee, tm0, st.seg_tmax)
        st.contrib = vselect(do_nee, c0, st.contrib)

    def resolve(st):
        """Bank a finished shadow ray's contribution and chain to the next
        light, or resume the bounce ray / regeneration."""
        parked = (st.state == _SH_LIT) | (st.state == _SH_OCC)
        lit = st.state == _SH_LIT
        if record_banks:
            # st.bounce was already incremented by the staging shade
            slot = ((st.bounce - 1) * n_paths + st.s_idx) * n_l + st.li
            _bank_write(banks[3], slot, parked,
                        torch.where(lit, 3.4e38, 0.0))
        st.extra = Vec3(*(a + torch.where(lit, c, 0.0)
                          for a, c in zip(st.extra, st.contrib)))
        li2 = st.li + 1
        more = parked & (li2 < scene.n_lights)
        for k, (dl, tl, cl) in enumerate(st.sh_store):
            sel = more & (li2 == k + 1)
            st.sh_d = vselect(sel, dl, st.sh_d)
            st.seg_tmax = torch.where(sel, tl, st.seg_tmax)
            st.contrib = vselect(sel, cl, st.contrib)
        st.state = torch.where(parked, torch.where(more, _SHADOW, st.resume),
                               st.state)
        # lanes leaving the chain march their bounce ray again, uncapped
        st.seg_tmax = torch.where(parked & ~more, cfg.max_dist, st.seg_tmax)
        st.li = torch.where(parked, torch.where(more, li2, 0), st.li)
        st.t = torch.where(parked, 0.0, st.t)
        st.steps = torch.where(parked, seg0(st), st.steps)
        if relax:
            reset_relax(st, parked)

    def bank_miss(st, miss_pending):
        """Bank each parked miss's (throughput, packed (u, v)) at its
        path's slot."""
        for bank, v in zip(banks, (*st.thr, pack_uv(st.d))):
            _bank_write(bank, st.s_idx, miss_pending, v)

    def regen(st):
        """Bank finished paths and respawn the lane on its next path."""
        pending = st.state == _REGEN
        val = st.thr + st.extra if nee else st.thr
        st.acc = Vec3(*(a + torch.where(pending, v, 0.0)
                        for a, v in zip(st.acc, val)))
        if defer_sky:
            # a parked miss banks its event; only its NEE radiance joins
            # the sum (the sky term is the composite's)
            miss_pending = st.state == _WAIT_MISS
            bank_miss(st, miss_pending)
            if nee:
                st.acc = Vec3(*(a + torch.where(miss_pending, e, 0.0)
                                for a, e in zip(st.acc, st.extra)))
            pending = pending | miss_pending
        st.s_idx = torch.where(pending, st.s_idx + 1, st.s_idx)
        exhausted = st.s_idx >= n_paths
        st.state = torch.where(
            pending, torch.where(exhausted, _EXH, _MARCH), st.state)
        st.o = vselect(pending, eye, st.o)
        st.d = vselect(pending, primary(st.s_idx), st.d)
        st.thr = vselect(pending, lane_channels(st.s_idx), st.thr)
        st.t = torch.where(pending, 0.0, st.t)
        st.steps = torch.where(pending, seg0(st), st.steps)
        st.bounce = torch.where(pending, 0, st.bounce)
        st.inside = torch.where(pending, 0.0, st.inside)
        if nee:
            st.extra = vselect(pending, zeros3, st.extra)
        if relax:
            reset_relax(st, pending)

    def cheap_pass(st):
        """Cadence pass: retire finished paths (and resolve parked shadow
        rays) without the shade pass's map, normal and materials."""
        if lazy_miss:
            mark_misses(st)
        if nee:
            resolve(st)
        regen(st)

    def parked_pass(st):
        shade(st)
        if nee:
            resolve(st)
        regen(st)

    def body(st):
        _count_bodies(work, st.state)
        if regen_cadence and regen_cadence < march_unroll:
            n_sub = march_unroll // regen_cadence
            for c in range(n_sub):
                for _ in range(regen_cadence):
                    march_step(st)
                if c < n_sub - 1:
                    cheap_pass(st)
        else:
            for _ in range(march_unroll):
                march_step(st)
        if lazy_miss:
            mark_misses(st)
        parked_pass(st)

    st = _PathLanes()
    st.o, st.d, st.t = eye, primary(izero), zero
    st.thr, st.acc, st.inside = lane_channels(izero), zeros3, zero
    st.bounce, st.s_idx, st.state, st.steps = izero, izero, izero, izero
    st.omega = torch.full_like(zero, max(cfg.relax_omega, 1.0))
    st.prev_r, st.step_len = zero, zero
    st.gstep = 0
    if nee:
        st.sh_o, st.sh_d, st.contrib, st.extra = zeros3, zeros3, zeros3, zeros3
        st.seg_tmax = torch.full_like(zero, cfg.max_dist)
        st.resume, st.li = izero, izero
        st.sh_store = [(zeros3, zero, zeros3)
                       for _ in range(scene.n_lights - 1)]
    march_step(st)                      # the peeled first step
    while bool((st.state < _EXH).any()):
        body(st)
    return (st.acc, banks) if record_banks or defer_sky else st.acc
