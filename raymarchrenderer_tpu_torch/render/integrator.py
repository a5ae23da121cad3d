"""The wavefront RGB integrator: the JAX package's `render/integrator.py`.

  * `march` — the per-ray sphere trace over planes of rays (classic, or
    safeguarded over-relaxed when `cfg.relax_omega > 1`), the plain
    version of the CUDA kernel `march_fused` (`csrc/march_fused.cu`);
  * `get_normal` — SDF-gradient normals: 4 or 6 taps, or the exact
    gradient (`normal_taps=0`, `exact_gradient`);
  * `trace_rgb` — gen-1 `trace` (`RayMarch.glsl:483-565`) as one Python
    loop over bounces over masked planes, with next-event estimation
    (`_direct_light`), Russian roulette and, with `differentiable=True`,
    the implicit-function march adjoint of `diff/march.py`;
  * `render_patch` / `render_patch_spp` — one sample of a patch, or all
    samples at once with the sample axis folded into the rows (the train
    step's layout);
  * `render_sample`, `accumulate`, `render` — the oracle progressive
    render (`render --impl oracle`): one full-frame sample at a time,
    folded into a running mean.

`march_impl` picks how every march of `trace_rgb` runs: "oracle" is
`march` here; "fused" is `kernels.march.march_fused` (the CUDA kernel for
CUDA tensors, `march` for CPU tensors); "recorded" replays the banks of
the recording megakernel (`kernels.record.trace_record_fused`), and is
the differentiable forward only.  The JAX package's choice between an
unrolled and a scanned replay is a compile-time matter with no
counterpart here.  `trace_rgb(defer_sky=True)` leaves the sky out and
returns each path's miss event (throughput and direction) for a
composite outside, as the env-map kernels do; `march(with_steps=True)`
adds each lane's count of map evaluations (the occupancy readings of
the march kernels).
"""
from __future__ import annotations

import torch

from raymarchrenderer_tpu_torch.core.rng import RNGStream
from raymarchrenderer_tpu_torch.core.sampling import uniform_sphere
from raymarchrenderer_tpu_torch.core.vecmath import Vec3, div, vselect
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.raygen import eye_vec, primary_rays
from raymarchrenderer_tpu_torch.scene.graph import Scene
from raymarchrenderer_tpu_torch.scene.nodes import ShadeCtx

_PI = 3.14159265358979323846
_TETRA = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
          (1.0, 1.0, 1.0))
MARCH_IMPLS = ("oracle", "fused", "recorded")


def march(scene: Scene, params, cfg: RenderConfig, o: Vec3, d: Vec3,
          dist_mult, active, t_max=None, work: dict = None,
          with_steps: bool = False):
    """Sphere trace of every lane of the planes `o`, `d`: returns
    (t, material index, hit mask).

    Per step (`RayMarch.glsl:233-257`): evaluate `map(o + t d) * dist_mult`;
    a hit when it is below `hit_eps` (returning the pre-step t), a miss
    when `t >= t_max`; advance by `dist * step_multiply`; give up after
    `max_steps` (a miss).  A miss returns t = t_max and material -1.
    `t_max` (a float or a per-lane plane, default `cfg.max_dist`) caps the
    segment: shadow rays stop at the light.  `active` is a bool plane;
    inactive lanes return as misses.  The loop ends when every lane is
    done, which changes no lane's result.  `work`, when given, gains under
    "march" the map evaluations of live lanes (a device tensor), what a
    one-thread-per-ray kernel evaluates, and a list under "lane_steps"
    gains each call's per-lane counts.  `with_steps=True` returns a 4th
    output, each lane's count of map evaluations (int32): the steps it was
    live, which sum to that "march" count."""
    if cfg.relax_omega > 1.0:
        return _march_relaxed(scene, params, cfg, o, d, dist_mult, active,
                              t_max, work, with_steps)
    tmax = cfg.max_dist if t_max is None else t_max
    shape = o.x.shape
    dev = o.x.device
    t = torch.zeros(shape, dtype=torch.float32, device=dev)
    mid = torch.full(shape, -1, dtype=torch.int32, device=dev)
    hitm = torch.zeros(shape, dtype=torch.bool, device=dev)
    done = ~active
    steps = torch.zeros(shape, dtype=torch.int32, device=dev)
    lanes = None if work is None else work.get("lane_steps")
    count = with_steps or lanes is not None
    for _ in range(cfg.max_steps):
        if bool(done.all()):
            break
        dist, m = scene.map(params, o + d * t, cfg.max_dist)
        dist = dist * dist_mult
        live = ~done
        if work is not None:
            work["march"] = work.get("march", 0) + live.sum()
        if count:
            steps = steps + live.to(torch.int32)
        is_hit = (dist < cfg.hit_eps) & live
        is_miss = (t >= tmax) & live & ~is_hit
        mid = torch.where(is_hit, m, mid)
        hitm = hitm | is_hit
        done = done | is_hit | is_miss
        t = torch.where(done, t, t + dist * cfg.step_multiply)
    if lanes is not None:
        lanes.append(steps)
    out = (torch.where(hitm, t, tmax), torch.where(hitm, mid, -1), hitm)
    return (*out, steps) if with_steps else out


def _march_relaxed(scene: Scene, params, cfg: RenderConfig, o: Vec3,
                   d: Vec3, dist_mult, active, t_max=None, work=None,
                   with_steps: bool = False):
    """Safeguarded over-relaxed sphere trace (Keinert et al. 2014): a step
    t += dist * omega stands only while consecutive unbounding spheres
    overlap (dist + prev_r >= step_len); on a failure the lane backs off by
    step_len * (1 - omega) and finishes the segment at omega = 1.  Same
    contract as `march` (`work`, `with_steps` included)."""
    tmax = cfg.max_dist if t_max is None else t_max
    shape = o.x.shape
    dev = o.x.device
    t = torch.zeros(shape, dtype=torch.float32, device=dev)
    mid = torch.full(shape, -1, dtype=torch.int32, device=dev)
    hitm = torch.zeros(shape, dtype=torch.bool, device=dev)
    done = ~active
    omega = torch.full(shape, cfg.relax_omega, dtype=torch.float32,
                       device=dev)
    prev_r = torch.zeros(shape, dtype=torch.float32, device=dev)
    step_len = torch.zeros(shape, dtype=torch.float32, device=dev)
    steps = torch.zeros(shape, dtype=torch.int32, device=dev)
    lanes = None if work is None else work.get("lane_steps")
    count = with_steps or lanes is not None
    for _ in range(cfg.max_steps):
        if bool(done.all()):
            break
        dist, m = scene.map(params, o + d * t, cfg.max_dist)
        dist = dist * dist_mult
        live = ~done
        if work is not None:
            work["march"] = work.get("march", 0) + live.sum()
        if count:
            steps = steps + live.to(torch.int32)
        fail = live & (omega > 1.0) & (dist + prev_r < step_len)
        is_hit = live & ~fail & (dist < cfg.hit_eps)
        is_miss = live & ~fail & ~is_hit & (t >= tmax)
        mid = torch.where(is_hit, m, mid)
        hitm = hitm | is_hit
        done = done | is_hit | is_miss
        adv = live & ~done
        new_len = torch.where(fail, step_len * (1.0 - omega), dist * omega)
        omega = torch.where(fail, 1.0, omega)
        prev_r = torch.where(adv, torch.abs(dist), prev_r)
        step_len = torch.where(adv, torch.abs(new_len), step_len)
        t = torch.where(adv, t + new_len, t)
    if lanes is not None:
        lanes.append(steps)
    out = (torch.where(hitm, t, tmax), torch.where(hitm, mid, -1), hitm)
    return (*out, steps) if with_steps else out


def get_normal(scene: Scene, params, cfg: RenderConfig, p: Vec3) -> Vec3:
    """`normal_taps=6`: central differences (`RayMarch.glsl:259-268`,
    eps = cfg.normal_eps); `normal_taps=4`: tetrahedron differences;
    `normal_taps=0`: the exact gradient of the map at p by one reverse
    sweep, normalised (`exact_gradient`)."""
    e = cfg.normal_eps

    def md(q):
        return scene.map_dist(params, q, cfg.max_dist)

    if cfg.normal_taps == 0:
        return exact_gradient(scene, params, cfg, p).normalized()
    if cfg.normal_taps == 4:
        n = Vec3(0.0, 0.0, 0.0)
        for kx, ky, kz in _TETRA:
            k = Vec3(kx, ky, kz)
            n = n + k * md(p + k * e)
        return n.normalized()
    return Vec3(md(Vec3(p.x + e, p.y, p.z)) - md(Vec3(p.x - e, p.y, p.z)),
                md(Vec3(p.x, p.y + e, p.z)) - md(Vec3(p.x, p.y - e, p.z)),
                md(Vec3(p.x, p.y, p.z + e)) - md(Vec3(p.x, p.y, p.z - e))
                ).normalized()


def exact_gradient(scene: Scene, params, cfg: RenderConfig, p: Vec3) -> Vec3:
    """The gradient of `scene.map_dist` at p, the plain version of the
    kernels' reverse sweep (`grad_map`, csrc/scene_map.cuh), with the JAX
    package's derivatives at the kinks (`core.sdf`).  Where grad mode is on
    and p or a scene parameter carries a graph (a train replay), the sweep
    keeps its graph (`create_graph=True`), so the normal carries its own
    derivatives w.r.t. the parameters and p, as `jax.grad` through the
    JAX package's `jax.vjp` does; the sweep keeps its own saved tensors
    (saved-tensor hooks), so it also runs inside `torch.utils.checkpoint`.
    Otherwise it is `diff.march._surface_gradient`'s detached sweep."""
    from raymarchrenderer_tpu_torch.diff.march import (_keep, _leaves,
                                                       _surface_gradient)
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (*p, *_leaves(params))
            if isinstance(t, torch.Tensor)):
        return _surface_gradient(scene, cfg, params, p)
    # the kept graph's saved tensors are packed as data: a saved output
    # packed with its own grad_fn would hold its node in a cycle that
    # outlives the step (autograd reattaches the grad_fn on unpacking)
    hooks = torch.autograd.graph.saved_tensors_hooks(torch.Tensor.detach,
                                                     _keep)
    with hooks:
        q = Vec3(*(c if c.requires_grad else c.detach().requires_grad_(True)
                   for c in p))
        f = scene.map_dist(params, q, cfg.max_dist)
        g = (torch.autograd.grad(f, tuple(q), torch.ones_like(f),
                                 create_graph=True, allow_unused=True)
             if f.requires_grad else (None,) * 3)
    return Vec3(*(torch.zeros_like(c) if gc is None else gc
                  for gc, c in zip(g, q)))


def _detach(v: Vec3) -> Vec3:
    return Vec3(*(c.detach() for c in v))


def _zeros3(shape, device) -> Vec3:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return Vec3(z, z, z)


def _direct_light(scene: Scene, params, cfg: RenderConfig, hitp: Vec3,
                  normal: Vec3, throughput: Vec3, albedo: Vec3,
                  rng: RNGStream, mask, shadow_march=None,
                  work: dict = None) -> Vec3:
    """Next-event estimation toward every sphere light (the gen-2 pattern,
    `RayMarch2.glsl:480-501`): throughput * albedo * cos+ * power / dist^2
    / pi, where a shadow march toward a jittered point of the light
    reaches it.  The shadow march is detached (visibility is binary) and
    capped at the light's distance; `shadow_march(o, d, dist_mult,
    active, t_max, light)` replaces `march` (the fused kernel, or the
    recorded visibility).  `work` counts the plain march's steps as
    `march` does."""
    shape = hitp.x.shape
    total = _zeros3(shape, hitp.x.device)
    ones = torch.ones(shape, dtype=torch.float32, device=hitp.x.device)
    for li in range(scene.n_lights):
        lrng = rng.fork(101 + li)
        lpos, lpower, lradius = scene.light(params, li)
        target = lpos + uniform_sphere(lrng.next(), lrng.next()) * lradius
        delta = target - hitp
        dist_l = delta.length()
        ldir = delta / torch.clamp(dist_l, min=1e-8)
        o_sh = hitp + normal * cfg.surface_offset
        if shadow_march is None:
            with torch.no_grad():
                sd, _, _ = march(scene, params, cfg, _detach(o_sh),
                                 _detach(ldir), ones, mask,
                                 t_max=dist_l.detach(), work=work)
        else:
            sd, _, _ = shadow_march(_detach(o_sh), _detach(ldir), ones, mask,
                                    dist_l.detach(), li)
        lit = sd >= dist_l
        cos_t = torch.clamp(ldir.dot(normal), min=0.0)
        fall = lpower / torch.clamp(dist_l * dist_l, min=1e-8)
        contrib = throughput * albedo * div(cos_t * fall, _PI)
        total = total + vselect(lit & mask, contrib, _zeros3(shape,
                                                             hitp.x.device))
    return total


def _march_fns(scene, params, cfg, march_impl, differentiable, work=None):
    """(march_fn(o, d, dist_mult, active, rec_b), shadow_march or None) of
    one `march_impl`; `work` counts the plain march's steps (oracle, not
    differentiable)."""
    from raymarchrenderer_tpu_torch.diff import march as dmarch
    from raymarchrenderer_tpu_torch.kernels.march import march_fused
    if march_impl not in MARCH_IMPLS:
        raise ValueError(f"march_impl must be one of {MARCH_IMPLS}")
    if march_impl == "recorded":
        if not differentiable:
            raise ValueError("recorded mode is the differentiable forward; "
                             "use the fused kernel for plain rendering")

        def march_fn(o, d, dist_mult, active, rec_b):
            return dmarch.march_diff_recorded(scene, cfg, params, o, d, active,
                                              rec_b["t"], rec_b["mid"],
                                              rec_b["hit"])
        return march_fn, None
    shadow = None
    if march_impl == "fused":
        def shadow(o, d, m, a, tm, _li):
            return march_fused(scene, params, cfg, o, d, m, a, t_max=tm)
    if differentiable:
        diff_fn = (dmarch.march_diff_fused if march_impl == "fused"
                   else dmarch.march_diff)

        def march_fn(o, d, dist_mult, active, _rec_b):
            return diff_fn(scene, cfg, params, o, d, dist_mult, active)
    elif march_impl == "fused":
        def march_fn(o, d, dist_mult, active, _rec_b):
            return march_fused(scene, params, cfg, o, d, dist_mult, active)
    else:
        def march_fn(o, d, dist_mult, active, _rec_b):
            with torch.no_grad():
                return march(scene, params, cfg, o, d, dist_mult, active,
                             work=work)
    return march_fn, shadow


def trace_rgb(scene: Scene, params, cfg: RenderConfig, eye: Vec3, d0: Vec3,
              px, py, sample, channels: Vec3, direct_light: bool = False,
              differentiable: bool = False, defer_sky: bool = False,
              march_impl: str = "oracle", recorded=None,
              work: dict = None, check=None) -> Vec3:
    """Gen-1 `trace` over planes of rays: the colour of each lane's path
    (throughput times the sky on a miss, plus the NEE radiance).  With
    `defer_sky=True` a miss multiplies by zero instead, and the return is
    (colour, miss throughput, miss direction): a path misses at most once,
    so `colour + miss_thr * sky(miss_dir)` is the path's colour (the miss
    Vec3s are zero for a path that never missed).

    Paths end on an emitter (dir == 0), a sky miss or after
    `cfg.max_bounces` bounces (then the bare throughput is returned, as
    the reference's loop falling off the end); `inside` flips the march's
    sign inside dielectrics.  `sample` is the RNG's sample plane (or
    scalar); `channels` the path's colour mask.  `differentiable=True`
    attaches implicit-function gradients to every hit distance
    (`diff.march`); `march_impl="recorded"` replays `recorded`, the banks
    of `kernels.record.trace_record_fused` for these planes.  `work`, with
    the oracle march, gains the map evaluations a one-thread-per-path
    kernel makes: "march" (steps of live lanes, shadow rays included) and
    "shade" (hits shaded: `normal_taps` evaluations each, 2 for the exact
    gradient; the march returns the material).  `check(stage, bounce,
    value)`, when given, sees each bounce's march t ("march t"), normal
    ("normal") and shaded colour ("shade colour"): `utils.guards`."""
    if march_impl == "recorded" and recorded is None:
        raise ValueError("march_impl='recorded' needs recorded planes")
    march_fn, shadow_march = _march_fns(scene, params, cfg, march_impl,
                                        differentiable, work)
    shape = d0.x.shape
    dev = d0.x.device
    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    ones3 = Vec3(ones, ones, ones)
    zeros3 = _zeros3(shape, dev)
    n_l = scene.n_lights
    o, d, color, extra = eye, d0, channels, zeros3
    miss_thr, miss_dir = zeros3, zeros3
    inside = torch.zeros(shape, dtype=torch.float32, device=dev)
    active = torch.ones(shape, dtype=torch.bool, device=dev)
    for b in range(cfg.max_bounces):
        rec_b = None
        if recorded is not None:
            rec_b = {k: recorded[k][b] for k in ("t", "mid", "hit")}
            if "sd" in recorded:
                sd_b = recorded["sd"][b * n_l:(b + 1) * n_l]

                def shadow_march(o_, d_, m_, a_, tm_, li, sd_b=sd_b):
                    return sd_b[li], None, None
        dist_mult = 1.0 - 2.0 * inside
        t, mid, hitm = march_fn(o, d, dist_mult, active, rec_b)
        hitp = o + d * t
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, sample, b)
        s = scene.shade(params, ShadeCtx(o, d, t, hitp, inside, normal,
                                         channels, rng), mid)
        if check is not None:
            check("march t", b, t)
            check("normal", b, normal)
            check("shade colour", b, s.color)
        hit_active = active & hitm
        miss_active = active & ~hitm
        if work is not None:
            work["shade"] = work.get("shade", 0) + hit_active.sum()
        if defer_sky:
            # bank the miss event; the caller composites its sky
            miss_thr = vselect(miss_active, color, miss_thr)
            miss_dir = vselect(miss_active, d, miss_dir)
            sky = zeros3
        else:
            sky = scene.sky(params, d)
        throughput = color
        color = color * vselect(hit_active, s.color,
                                vselect(miss_active, sky, ones3))
        new_inside_b = s.inside.x > 0.5
        inside = torch.where(hit_active, new_inside_b.to(torch.float32),
                             inside)
        term = (s.dir.x == 0.0) & (s.dir.y == 0.0) & (s.dir.z == 0.0)
        active = hit_active & ~term
        if direct_light and n_l:
            extra = extra + _direct_light(
                scene, params, cfg, hitp, normal, throughput, s.color,
                rng.fork(7), active, shadow_march=shadow_march, work=work)
        if cfg.rr_start_bounce >= 0:
            p = torch.clamp(color.max_component(), cfg.rr_min_prob, 1.0)
            u = rng.fork(13).next()
            do_rr = active & (b >= cfg.rr_start_bounce)
            kill = do_rr & (u >= p)
            scale = torch.where(do_rr & ~kill, 1.0 / p, 1.0)
            color = vselect(kill, zeros3, color * scale)
            active = active & ~kill
        override = (s.hit.x != 0.0) | (s.hit.y != 0.0) | (s.hit.z != 0.0)
        off = torch.where(new_inside_b, -cfg.inside_offset, cfg.exit_offset)
        o_next = vselect(override, s.hit, hitp + normal * off)
        o = vselect(active, o_next, o)
        d = vselect(active, s.dir, d)
    if defer_sky:
        return color + extra, miss_thr, miss_dir
    return color + extra


def _full3(shape, device, c) -> Vec3:
    return Vec3(*(torch.full(shape, v, dtype=torch.float32, device=device)
                  for v in c))


_CHANNELS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _trace_channels(scene, params, cfg, eye, d, px, py, sample,
                    direct_light, differentiable, march_impl, recorded,
                    check=None):
    """One `trace_rgb` of white paths, or, with `cfg.separate_channels`
    (dispersion, `RayMarch.glsl:580-598`), the sum of three one-channel
    traces drawing the streams sample * 4 + channel + 1, each replaying
    its own channel's banks."""
    shape = d.x.shape
    if not cfg.separate_channels:
        return trace_rgb(scene, params, cfg, eye, d, px, py, sample,
                         _full3(shape, d.x.device, (1.0, 1.0, 1.0)),
                         direct_light, differentiable,
                         march_impl=march_impl, recorded=recorded,
                         check=check)
    total = _zeros3(shape, d.x.device)
    for ci, mask in enumerate(_CHANNELS):
        rec_ci = (None if recorded is None
                  else {k: v[ci] for k, v in recorded.items()})
        total = total + trace_rgb(
            scene, params, cfg, eye, d, px, py, sample * 4 + (ci + 1),
            _full3(shape, d.x.device, mask), direct_light, differentiable,
            march_impl=march_impl, recorded=rec_ci, check=check)
    return total


def spp_rays(cfg: RenderConfig, corners, origin_xy, patch_shape, sample0,
             n_samples: int):
    """The sample-folded planes of `render_patch_spp`, each
    (n_samples * ph, pw) on the corners' device: (px, py, sample, eye,
    primary direction); row s * ph + y is pixel row y of sample
    sample0 + s."""
    ph, pw = patch_shape
    S = int(n_samples)
    ox, oy = int(origin_xy[0]), int(origin_xy[1])
    dev = corners.device
    shape = (S * ph, pw)
    rows = torch.arange(ph, dtype=torch.int32, device=dev)[None, :, None]
    cols = torch.arange(pw, dtype=torch.int32, device=dev)[None, None, :]
    sid = (int(sample0) + torch.arange(S, dtype=torch.int64,
                                       device=dev))[:, None, None]
    py = (rows + oy).expand(S, ph, pw).reshape(shape)
    px = (cols + ox).expand(S, ph, pw).reshape(shape)
    sample = sid.expand(S, ph, pw).reshape(shape)
    rng = RNGStream(cfg.seed, px, py, sample, 1 << 20)
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    eye = Vec3(e.x.expand(shape), e.y.expand(shape), e.z.expand(shape))
    return px, py, sample, eye, d


def render_patch(scene: Scene, params, cfg: RenderConfig, corners,
                 origin_xy, patch_shape, sample, direct_light: bool = False,
                 differentiable: bool = False,
                 march_impl: str = "oracle", defer_sky: bool = False,
                 check=None):
    """One sample of the (ph, pw) patch at `origin_xy` = (x, y) of the
    frame, as a Vec3 of (ph, pw) planes on the corners' device.  The RNG
    is keyed on absolute pixel coordinates, so any patching of the frame
    gives the same pixels.

    `defer_sky=True` returns (colour, miss throughput, miss direction) as
    `trace_rgb(defer_sky=True)` does; with `cfg.separate_channels` the
    colour sums the three channel paths and the miss Vec3s hold each
    path's event on a leading axis of 3 (channel R, G, B).  `check` is
    `trace_rgb`'s (colour renders only)."""
    if not defer_sky:
        return render_patch_spp(scene, params, cfg, corners, origin_xy,
                                patch_shape, sample, 1, direct_light,
                                differentiable, march_impl, check=check)
    if march_impl == "recorded":
        raise ValueError("defer_sky renders; the recorded replay evaluates "
                         "its sky in place")
    px, py, samp, eye, d = spp_rays(cfg, corners, origin_xy, patch_shape,
                                    sample, 1)
    shape = d.x.shape
    if not cfg.separate_channels:
        return trace_rgb(scene, params, cfg, eye, d, px, py, samp,
                         _full3(shape, d.x.device, (1.0, 1.0, 1.0)),
                         direct_light, differentiable, defer_sky=True,
                         march_impl=march_impl)
    total, thr, mdir = _zeros3(shape, d.x.device), [], []
    for ci, mask in enumerate(_CHANNELS):
        c, t, md = trace_rgb(scene, params, cfg, eye, d, px, py,
                             samp * 4 + (ci + 1),
                             _full3(shape, d.x.device, mask), direct_light,
                             differentiable, defer_sky=True,
                             march_impl=march_impl)
        total = total + c
        thr.append(t)
        mdir.append(md)
    return (total, Vec3(*(torch.stack(v) for v in zip(*thr))),
            Vec3(*(torch.stack(v) for v in zip(*mdir))))


def render_patch_spp(scene: Scene, params, cfg: RenderConfig, corners,
                     origin_xy, patch_shape, sample0, n_samples: int,
                     direct_light: bool = False,
                     differentiable: bool = False,
                     march_impl: str = "oracle", recorded=None,
                     check=None) -> Vec3:
    """The per-pixel SUM of samples `sample0 .. sample0 + n_samples - 1`
    of a (ph, pw) patch, traced at once: the sample axis is folded into
    the rows, so every plane is (n_samples * ph, pw) and every march
    covers every sample.  The same sample set as `n_samples` calls of
    `render_patch`.  With `march_impl="recorded"` one launch of the
    recording megakernel marches every (sample, bounce) first, and
    `trace_rgb` replays the shading over its banks (`recorded`, when the
    caller has recorded them already)."""
    ph, pw = patch_shape
    S = int(n_samples)
    px, py, sample, eye, d = spp_rays(cfg, corners, origin_xy, patch_shape,
                                      sample0, S)
    if march_impl == "recorded" and recorded is None:
        from raymarchrenderer_tpu_torch.kernels.record import (
            trace_record_fused)
        recorded = trace_record_fused(scene, params, cfg, corners, origin_xy,
                                      patch_shape, sample0, n_samples=S,
                                      direct_light=direct_light)
    c = _trace_channels(scene, params, cfg, eye, d, px, py, sample,
                        direct_light, differentiable, march_impl, recorded,
                        check=check)
    return Vec3(*(v.reshape(S, ph, pw).sum(0) for v in c))


def render_sample(scene: Scene, params, cfg: RenderConfig, corners, sample,
                  direct_light: bool = False,
                  differentiable: bool = False, check=None) -> Vec3:
    """One full-frame sample (all pixels, 1 spp), the body of one
    `Graphics::Render` dispatch (`Graphics.cpp:314-354`) without tiling;
    with `cfg.separate_channels` the sum of the three channel paths, which
    draw the streams sample * 4 + channel + 1.  `check(stage, bounce,
    value)` sees every bounce's stages, as in `trace_rgb`."""
    return render_patch(scene, params, cfg, corners, (0, 0),
                        (cfg.height, cfg.width), sample, direct_light,
                        differentiable, check=check)


def accumulate(accum, color: Vec3, n):
    """Progressive running mean (`RayMarch.glsl:600-612`): new / (n + 1) +
    old * n / (n + 1), in float32; `accum` is (H, W, 3)."""
    n = torch.as_tensor(n, dtype=torch.float32, device=accum.device)
    f1 = 1.0 / (n + 1.0)
    f2 = n / (n + 1.0)
    return color.stack(-1) * f1 + accum * f2


def render(scene: Scene, params, cfg: RenderConfig, corners, spp: int = None,
           direct_light: bool = False, accum=None, n0: float = 0.0,
           callback=None):
    """The oracle progressive render: `spp` samples from sample `n0`, each
    `render_sample` folded into the running mean; resumable from (`accum`,
    `n0`).  `callback(s, (accum, n))` runs after each sample.  Returns
    (image (H, W, 3) float32, n)."""
    spp = cfg.spp if spp is None else spp
    if accum is None:
        accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                            device=corners.device)
    n = torch.tensor(float(n0), dtype=torch.float32, device=corners.device)
    with torch.no_grad():
        for s in range(int(n0), int(n0) + spp):
            color = render_sample(scene, params, cfg, corners, s,
                                  direct_light)
            accum, n = accumulate(accum, color, n), n + 1.0
            if callback is not None:
                callback(s, (accum, n))
    return accum, float(n)
