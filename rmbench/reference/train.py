"""The spectral inverse-rendering step, worked out again: the recording of
every (sample, bounce) march, the differentiable replay with the
implicit-function march adjoint and the soft band filter, the loss, its
gradients, and the update (SGD on the scene's leaves, a sign step on the
band rows, then the clamp).

Frozen copies of the port's plain pieces, with their imports pointed
here: `diff/march.py` (`_surface_gradient`, `reparam_t`),
`render/integrator.py::spp_rays`,
`render/spectral_integrator.py` (`_apply_band_soft`, the recorded,
differentiable branch of `trace_spectral`) and `parallel/sharding.py`
(`_clamp_bands`, `_loss`, `spectral_update`).  The recording is the
megakernel schedule of `mega.trace_mega_spectral(record_banks=True)`,
one lane per (pixel, sample) with each pixel's first sample peeled, at
the knobs the port records with on the step's device: on the card the
production schedule, on the CPU unroll 1, no cadence and the strict miss
test.
"""
from __future__ import annotations

import numpy as np
import torch

from rmbench.reference.bands import SpectralMaterials, _lookup
from rmbench.reference.config import RenderConfig
from rmbench.reference.graph import Scene, param_leaves, params_replace
from rmbench.reference.mega import trace_mega_spectral
from rmbench.reference.normals import get_normal
from rmbench.reference.raygen import eye_vec, primary_rays
from rmbench.reference.rng import RNGStream
from rmbench.reference.sampling import uniform_sphere_or_hemisphere
from rmbench.reference.spectral import wavelength_to_rgb
from rmbench.reference.vecmath import Vec3, vselect


def _keep(x):
    return x


def _detached_tree(tree):
    if isinstance(tree, dict):
        return {k: _detached_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached_tree(v) for v in tree]
    return tree.detach()


def _surface_gradient(scene, cfg, params, p: Vec3) -> Vec3:
    """grad f at the detached points `p` by one reverse sweep of the map
    over detached copies, with no graph left behind."""
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            _keep, _keep):
        q = Vec3(*(c.detach().requires_grad_(True) for c in p))
        f = scene.map_dist(_detached_tree(params), q, cfg.max_dist)
        g = (torch.autograd.grad(f, tuple(q), torch.ones_like(f),
                                 allow_unused=True) if f.requires_grad
             else (None,) * 3)
    return Vec3(*(torch.zeros_like(c) if gc is None else gc
                  for gc, c in zip(g, p)))


def reparam_t(scene, cfg, params, o: Vec3, d: Vec3, t, valid):
    """The detached hit distance `t` with implicit-function gradients
    attached (value `t` bitwise): -f_theta/(grad f . d), -grad f/(grad f
    . d), -t grad f/(grad f . d) where `valid` and |grad f . d| > 1e-6."""
    t_sg = t.detach()
    o_sg = Vec3(*(c.detach() for c in o))
    d_sg = Vec3(*(c.detach() for c in d))
    g = _surface_gradient(scene, cfg, params, o_sg + d_sg * t_sg)
    denom = g.x * d_sg.x + g.y * d_sg.y + g.z * d_sg.z
    safe = valid & (torch.abs(denom) > 1e-6)
    inv = torch.where(safe, 1.0 / torch.where(safe, denom, 1.0), 0.0)
    f = scene.map_dist(params, o + d * t_sg, cfg.max_dist)
    return t_sg - (f - f.detach()) * inv.detach()


def spp_rays(cfg: RenderConfig, corners, n_samples: int, sample0: int):
    """The whole frame's sample-folded planes, each (n_samples * H, W):
    (px, py, sample, eye, primary direction); row s * H + y is pixel row
    y of sample sample0 + s."""
    ph, pw = cfg.height, cfg.width
    S = int(n_samples)
    dev = corners.device
    shape = (S * ph, pw)
    rows = torch.arange(ph, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(pw, dtype=torch.int32, device=dev)[None, None, :]
    sid = (int(sample0) + torch.arange(S, dtype=torch.int64,
                                       device=dev))[:, None, None]
    py = rows.expand(S, ph, pw).reshape(shape)
    px = cols.expand(S, ph, pw).reshape(shape)
    sample = sid.expand(S, ph, pw).reshape(shape)
    rng = RNGStream(cfg.seed, px, py, sample, 1 << 20)
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    eye = Vec3(e.x.expand(shape), e.y.expand(shape), e.z.expand(shape))
    return px, py, sample, eye, d


def record(scene: Scene, params, mats, cfg: RenderConfig, corners,
           n_samples: int, sample0: int):
    """{"t", "mid", "hit"}, each (B, n_samples * H, W): the banks of every
    (bounce, sample) march of the frame."""
    S, h, w = int(n_samples), cfg.height, cfg.width
    dev = corners.device
    sid = torch.arange(S, dtype=torch.int64, device=dev)[:, None, None]
    sid = sid.expand(S, h, w).reshape(S * h, w)
    py = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
    px = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
    py = py.expand(S, h, w).reshape(S * h, w)
    px = px.expand(S, h, w).reshape(S * h, w)
    if dev.type == "cuda":
        knobs = dict(march_unroll=32, regen_cadence=16, lazy_miss=True)
    else:
        knobs = dict(march_unroll=1, regen_cadence=0, lazy_miss=False)
    with torch.no_grad():
        _, banks = trace_mega_spectral(
            scene, _detached_tree(params),
            SpectralMaterials(*(m.detach() for m in mats)), cfg, corners,
            px, py, int(sample0) + sid, n_samples=1, shade_gate=0.0,
            record_banks=True, peel=sid == 0, **knobs)
    return dict(zip(("t", "mid", "hit"), banks))


def _apply_band_soft(wl, power, u, min_w, max_w, mat_p, edge):
    """The differentiable band filter: the unset draw is continuous, the
    absorb test a boxcar transmission of sigmoids with edge `edge` nm;
    the path continues."""
    sampled = min_w + u * (max_w - min_w)
    unset = wl == 0.0
    t_soft = (torch.sigmoid((wl - min_w) / edge)
              * torch.sigmoid((max_w - wl) / edge))
    new_wl = torch.where(unset, sampled, wl)
    new_power = power * mat_p * torch.where(unset, 1.0, t_soft)
    return new_wl, new_power, torch.zeros_like(unset)


def trace_recorded(scene: Scene, params, mats, cfg: RenderConfig, eye: Vec3,
                   d0: Vec3, px, py, sample, recorded,
                   soft_edge: float = 8.0):
    """Gen-3 `trace` over the recorded marches, differentiable: (wl,
    power) per lane."""
    def band(*a):
        return _apply_band_soft(*a, edge=soft_edge)

    shape = d0.x.shape
    dev = d0.x.device
    sky_min, sky_max = 390.0, 830.0
    sky_p = float(np.float32(cfg.sky_power))
    o, d = eye, d0
    wl = torch.zeros(shape, dtype=torch.float32, device=dev)
    power = torch.ones(shape, dtype=torch.float32, device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    for b in range(cfg.max_bounces):
        hitm = recorded["hit"][b] > 0
        mid = recorded["mid"][b]
        t = reparam_t(scene, cfg, params, o, d, recorded["t"][b],
                      hitm & active)
        hitp = o + d * t
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, sample, b)
        m_min, m_max, m_pow, m_kind = _lookup(mats, mid)
        u = rng.next()
        hit_active = active & hitm
        miss_active = active & ~hitm
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
    return wl, power


def _clamp_bands(minw, maxw, power):
    """Band rows inside [380, 830] nm with max >= min + 5, power >= 1e-4,
    each bound as minimum(maximum(x, lo), hi)."""
    def lo_hi(x, lo, hi):
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
        if hi is None:
            return x
        return torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                                device=x.device))

    minw = lo_hi(minw, 380.0, 825.0)
    maxw = lo_hi(maxw, minw + 5.0, 830.0)
    return minw, maxw, lo_hi(power, 1e-4, None)


def loss_and_grads(scene: Scene, params, mats, cfg: RenderConfig, corners,
                   target, spp: int, sample0: int):
    """(loss, scene leaves' gradients, band rows' gradients) of one step:
    the mean squared error of the frame's mean over `spp` samples from
    `sample0` against `target`."""
    recorded = record(scene, params, mats, cfg, corners, spp, sample0)
    px, py, sample, eye, d = spp_rays(cfg, corners, spp, sample0)
    leaves = [x.detach().requires_grad_(True) for x in param_leaves(params)]
    bands = [b.detach().requires_grad_(True) for b in mats[:3]]
    fit = params_replace(params, leaves)
    with torch.enable_grad():
        m = SpectralMaterials(*_clamp_bands(*bands), mats.kind)
        wl, power = trace_recorded(scene, fit, m, cfg, eye, d, px, py,
                                   sample, recorded)
        c = wavelength_to_rgb(wl) * power
        h, w = cfg.height, cfg.width
        acc = torch.stack([v.reshape(spp, h, w).sum(0) for v in c], dim=-1)
        img = acc / float(spp)
        loss = torch.sum((img - target) ** 2) / float(h * w * 3)
        xs = leaves + bands
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, xs)]
    return loss.detach(), grads[:len(leaves)], grads[len(leaves):]


def update(params, mats, grads, band_grads, lr: float,
           lr_bands_nm: float = 3.0):
    """(p - lr * g on every scene leaf, the band rows stepped by sign:
    lr_bands_nm nm for min and max, 0.01 * lr_bands_nm for power, then
    clamped)."""
    step = float(np.float32(lr_bands_nm))
    step_p = float(np.float32(0.01) * np.float32(lr_bands_nm))
    g_min, g_max, g_pow = band_grads
    bands = _clamp_bands(mats.min_wave.detach() - step * torch.sign(g_min),
                         mats.max_wave.detach() - step * torch.sign(g_max),
                         mats.power.detach() - step_p * torch.sign(g_pow))
    leaves = [p.detach() - lr * g for p, g in zip(param_leaves(params),
                                                  grads)]
    return params_replace(params, leaves), SpectralMaterials(*bands,
                                                             mats.kind)
