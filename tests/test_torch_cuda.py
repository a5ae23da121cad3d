"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (`requires_cuda`) and skips without one.
No JAX: on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX).  The bar is the
one the JAX package sets for its own kernel: fewer than 1e-3 of the values
off by more than 1e-5; with NEE or a colour computed at the hit (float
math), its NEE bar.  The recorder's banks and `march_fused`'s planes:
fewer than 1e-3 of the entries with another material or hit verdict (or
NEE visibility), and fewer than 1e-3 of those where both hit with t off
by more than 1e-5; at a later bounce of the banks, whose ray starts from
a direction an ulp apart between the kernel and torch's CUDA build
(sinf, cosf), fewer than 5% off by more than 1e-4, with no bound on the
largest: a grazing ray that starts an ulp away stops at another point of
the surface (measured on csg_demo with NEE: 1.25% and 0.22).  Gradients
from kernel banks against plain banks (the same replay): loss to rtol
1e-5, every leaf to atol 1e-3 * max|g|.  The spectral recorder and the
wavefront recorder are held to the banks' bar; the wavefront recorder
also against the mega recorder (kernel #5) on the same rays, with the
bar of tests/test_diff.py:481-497 (decisions and visibility off on fewer
than 5e-3 of the entries, t on both-hit entries within 5e-3 on all but
5% of the later bounces' entries).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (ALL_MATERIALS_SCENE, ALL_NODES_SCENE,  # noqa: F401
                           LATER_FRAC_OFF, MAX_FRAC_OFF,
                           assert_nee_close, bank_parity, cuda_device,
                           frac_off)

from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.kernels import march
from raymarchrenderer_tpu_torch.kernels.record import (
    record_plain, record_spectral_plain, record_wavefront_plain,
    trace_record_fused, trace_record_fused_spectral, trace_record_wavefront)
from raymarchrenderer_tpu_torch.parallel.sharding import (
    train_grads_sharded, train_grads_spectral_sharded)
from raymarchrenderer_tpu_torch.render import integrator
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.mega import (trace_mega_paths,
                                                    trace_mega_spectral)
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.render.spectral_integrator import band_table
from raymarchrenderer_tpu_torch.scene import builtin, loads_scene
from raymarchrenderer_tpu_torch.scene import param_leaves

_STRICT = dict(relax=0.0, taps=6, lazy_miss=False, march_unroll=4,
               regen_cadence=0)
_PRODUCTION = dict(relax=2.0, taps=4, lazy_miss=True, march_unroll=32,
                   regen_cadence=16)


def _scene(name):
    return (builtin.sphere_on_floor() if name == "demo"
            else loads_scene(ALL_NODES_SCENE))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene_name", ["demo", "all_nodes"])
@pytest.mark.parametrize("knobs", [_STRICT, _PRODUCTION],
                         ids=["strict", "production"])
def test_kernel_matches_plain(cuda_device, scene_name, knobs):
    """Kernel vs plain version on the same CUDA tensors, on a patch at a
    non-zero origin; the launch counter rises by exactly one."""
    scene = _scene(scene_name)
    params = scene.init_params(cuda_device)
    mats = band_table(scene, cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       max_dist=100.0, relax_omega=knobs["relax"],
                       normal_taps=knobs["taps"])
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    sched = {k: knobs[k] for k in ("lazy_miss", "march_unroll",
                                   "regen_cadence")}
    launches = march.MEGA_SPECTRAL.launches
    got = march.render_fused_spectral(scene, params, mats, cfg, corners, 2,
                                      n_samples=3, origin_xy=(8, 4),
                                      patch_shape=(48, 80), **sched)
    torch.cuda.synchronize()
    assert march.MEGA_SPECTRAL.launches == launches + 1
    assert got.shape == (48, 80, 3) and got.device == corners.device
    px, py = pixel_grid(80, 48, cuda_device, (8, 4))
    plain = trace_mega_spectral(scene, params, mats, cfg, corners, px, py, 2,
                                n_samples=3, **sched).stack(-1)
    plain = plain * float(np.float32(1.0 / 3.0))
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0.0
    assert frac_off(plain.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    scene = builtin.sphere_on_floor()
    cfg = RenderConfig(width=16, height=16, max_steps=32, max_bounces=2)
    corners = Camera().corner_rays_flat(cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        march.render_fused_spectral(scene, scene.init_params("cpu"),
                                    band_table(scene, cuda_device), cfg,
                                    corners, 0)


# (scene, direct_light, config extras, NEE bar)
_PATH_CASES = {
    "sphere_on_floor": ("demo", False, {}, False),
    "csg_nee": ("csg", True, {}, True),
    "csg_dispersion_nee_rr": ("csg", True, dict(separate_channels=True,
                                                rr_start_bounce=1), True),
    "all_materials_nee": ("all_materials", True, dict(rr_start_bounce=1),
                          True),
}


def _paths_scene(name):
    return {"demo": builtin.sphere_on_floor, "csg": builtin.csg_demo,
            "all_materials": lambda: loads_scene(ALL_MATERIALS_SCENE)}[name]()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_PATH_CASES))
@pytest.mark.parametrize("knobs", [_STRICT, _PRODUCTION],
                         ids=["strict", "production"])
def test_paths_kernel_matches_plain(cuda_device, case, knobs):
    """The RGB kernel vs its plain version on the same CUDA tensors, on a
    patch at a non-zero origin; the launch counter rises by exactly one."""
    name, nee, extra, nee_bar = _PATH_CASES[case]
    scene = _paths_scene(name)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       max_dist=100.0, relax_omega=knobs["relax"],
                       normal_taps=knobs["taps"], **extra)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    sched = {k: knobs[k] for k in ("lazy_miss", "march_unroll",
                                   "regen_cadence")}
    launches = march.MEGA_PATHS.launches
    got = march.render_fused_patch(scene, params, cfg, corners, (8, 4),
                                   (48, 80), 2, n_samples=3,
                                   direct_light=nee, **sched)
    torch.cuda.synchronize()
    assert march.MEGA_PATHS.launches == launches + 1
    assert got.shape == (48, 80, 3) and got.device == corners.device
    px, py = pixel_grid(80, 48, cuda_device, (8, 4))
    plain = trace_mega_paths(scene, params, cfg, corners, px, py, 2,
                             n_samples=3, direct_light=nee,
                             dispersion=cfg.separate_channels,
                             **sched).stack(-1)
    plain = plain * float(np.float32(1.0 / 3.0))
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0.0
    if nee_bar:
        assert_nee_close(plain.cpu().numpy(), got.cpu().numpy())
    else:
        assert frac_off(plain.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
def test_paths_kernel_rejects_mixed_devices(cuda_device):
    scene = builtin.csg_demo()
    params = scene.init_params(cuda_device)
    params["lights"] = {k: v.cpu() for k, v in params["lights"].items()}
    cfg = RenderConfig(width=16, height=16, max_steps=32, max_bounces=2)
    corners = Camera().corner_rays_flat(cuda_device)
    launches = march.MEGA_PATHS.launches
    with pytest.raises(ValueError, match="different devices"):
        march.render_fused(scene, params, cfg, corners, 0, direct_light=True)
    assert march.MEGA_PATHS.launches == launches


@pytest.mark.requires_cuda
def test_paths_kernel_rejects_too_many_lights(cuda_device):
    """The kernel's light table holds kMaxLights lights; the wrapper
    raises above it when NEE would read them, and renders without NEE."""
    b = builtin.SceneBuilder()
    m = b.diffuse([0.5, 0.5, 0.5])
    b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    for i in range(march.MAX_LIGHTS + 1):
        b.light([i - 4.0, 6.0, -3.0], 10.0, 0.3)
    scene = b.build()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=16, height=16, max_steps=32, max_bounces=2)
    corners = Camera().corner_rays_flat(cuda_device)
    with pytest.raises(ValueError, match="at most"):
        march.render_fused(scene, params, cfg, corners, 0, direct_light=True)
    img = march.render_fused(scene, params, cfg, corners, 0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())


# (scene, direct_light, config extras, samples)
_RECORD_CASES = {
    "sphere_on_floor": ("demo", False, {}, 2),
    "csg_nee": ("csg", True, {}, 2),
    "csg_dispersion_nee_rr": ("csg", True, dict(separate_channels=True,
                                                rr_start_bounce=1), 1),
}


def _assert_banks_match(got, want, bounce_axis=None):
    p = bank_parity(got, want, bounce_axis)
    assert set(got) == set(want)
    assert p["decisions"] < MAX_FRAC_OFF and p["t"] < MAX_FRAC_OFF, p
    assert p.get("sd", 0.0) < MAX_FRAC_OFF, p
    assert p["t_later"] < LATER_FRAC_OFF, p


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_RECORD_CASES))
def test_record_kernel_matches_plain(cuda_device, case):
    """The recording launch against its plain version with the same knobs
    (production: unroll 32, cadence 16, lazy miss unless NEE) on the same
    CUDA tensors, a patch at a non-zero origin; one launch."""
    name, nee, extra, n = _RECORD_CASES[case]
    scene = _paths_scene(name)
    params = scene.init_params(cuda_device)
    # the train workload's configuration (the CLI's max_steps, max_dist)
    cfg = RenderConfig(width=96, height=64, max_bounces=4, relax_omega=1.9,
                       normal_taps=4, **extra)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    launches = march.RECORD_PATHS.launches
    got = trace_record_fused(scene, params, cfg, corners, (8, 4), (48, 80), 0,
                             n_samples=n, direct_light=nee)
    torch.cuda.synchronize()
    assert march.RECORD_PATHS.launches == launches + 1
    want = record_plain(scene, params, cfg, corners, (8, 4), (48, 80), 0,
                        n_samples=n, direct_light=nee)
    assert int(got["hit"].sum()) > 0
    _assert_banks_match(got, want, 1 if cfg.separate_channels else 0)


def _ray_planes(device, h=48, w=80, seed=5):
    """Camera rays, a quarter starting inside the ball with dist_mult -1,
    an eighth inactive, and a per-lane t_max."""
    rng = np.random.RandomState(seed)
    o = np.broadcast_to(np.float32([0.0, 4.0, -6.0]), (h, w, 3)).copy()
    d = (np.float32([0.0, -0.447, 0.894])
         + rng.uniform(-0.45, 0.45, (h, w, 3))).astype(np.float32)
    inside = rng.uniform(size=(h, w)) < 0.25
    o[inside] = np.float32([0.0, 1.0, 0.0]) + rng.uniform(
        -0.4, 0.4, (int(inside.sum()), 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
         for k, v in (("dm", np.where(inside, -1.0, 1.0)),
                      ("tmax", rng.uniform(2.0, 12.0, (h, w))))}
    act = torch.from_numpy(rng.uniform(size=(h, w)) >= 0.125).to(device)
    vec = [Vec3(*(torch.from_numpy(np.ascontiguousarray(a[..., k],
                                                        np.float32)).to(device)
                  for k in range(3))) for a in (o, d)]
    return vec[0], vec[1], t["dm"], act, t["tmax"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("relax", [0.0, 1.9], ids=["classic", "relaxed"])
def test_march_fused_kernel_matches_plain(cuda_device, relax):
    """`march_fused` against `integrator.march` on the same CUDA planes,
    with and without t_max; one launch each."""
    scene = builtin.sphere_on_floor()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=80, height=48, max_steps=160, max_dist=100.0,
                       relax_omega=relax)
    o, d, dm, act, tmax = _ray_planes(cuda_device)
    for t_max in (None, tmax):
        launches = march.MARCH_FUSED.launches
        t, mid, hit = march.march_fused(scene, params, cfg, o, d, dm, act,
                                        t_max=t_max)
        torch.cuda.synchronize()
        assert march.MARCH_FUSED.launches == launches + 1
        assert hit.dtype == torch.bool and mid.dtype == torch.int32
        pt, pmid, phit = integrator.march(scene, params, cfg, o, d, dm, act,
                                          t_max=t_max)
        _assert_banks_match({"t": t, "mid": mid, "hit": hit.int()},
                            {"t": pt, "mid": pmid, "hit": phit.int()})
        assert 0 < int(hit.sum()) < hit.numel()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,nee", [("demo", False), ("csg", True)])
def test_train_grads_kernel_banks_match_plain_banks(cuda_device, name, nee):
    """One train step's loss and gradients replayed over the recorder's
    banks and over its plain version's, and with `march_fused` against
    the plain march: each leaf to atol 1e-3 * max|g|, with NEE the JAX
    package's NEE bar 2e-2 * max|g| (tests/test_diff.py:409-413)."""
    scene = _paths_scene(name)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=64, height=48, max_bounces=3, relax_omega=1.9,
                       normal_taps=4)
    corners = Camera(aspect=64 / 48).corner_rays_flat(cuda_device)
    target = torch.full((48, 64, 3), 0.2, device=cuda_device)
    kw = dict(spp=2, direct_light=nee)
    banks = {"kernel": trace_record_fused(scene, params, cfg, corners, (0, 0),
                                          (48, 64), 0, n_samples=2,
                                          direct_light=nee),
             "plain": record_plain(scene, params, cfg, corners, (0, 0),
                                   (48, 64), 0, n_samples=2,
                                   direct_light=nee)}
    pairs = [[train_grads_sharded(scene, params, cfg, corners, target,
                                  march_impl="recorded", recorded=banks[k],
                                  **kw) for k in ("kernel", "plain")],
             [train_grads_sharded(scene, params, cfg, corners, target,
                                  march_impl=m, **kw)
              for m in ("fused", "oracle")]]
    for (loss, grads), (want_loss, want_grads) in pairs:
        assert bool(torch.isfinite(loss))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        for g, w in zip(param_leaves(grads), param_leaves(want_grads)):
            if w.numel():
                tol = (2e-2 if nee else 1e-3) * max(1e-6, float(w.abs().max()))
                assert float((g - w).abs().max()) <= tol, (g, w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene_name", ["demo", "all_nodes"])
def test_record_spectral_kernel_matches_plain(cuda_device, scene_name):
    """The spectral recorder against its plain version with the card's
    knobs (unroll 32, cadence 16, lazy miss) on the same CUDA tensors: a
    patch at a non-zero origin, 3 samples from sample 2; one launch."""
    scene = _scene(scene_name)
    params = scene.init_params(cuda_device)
    mats = band_table(scene, cuda_device)
    cfg = RenderConfig(width=96, height=64, max_bounces=4, relax_omega=1.9,
                       normal_taps=4)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    launches = march.RECORD_SPECTRAL.launches
    got = trace_record_fused_spectral(scene, params, mats, cfg, corners,
                                      (8, 4), (48, 80), 2, n_samples=3)
    torch.cuda.synchronize()
    assert march.RECORD_SPECTRAL.launches == launches + 1
    want = record_spectral_plain(scene, params, mats, cfg, corners, (8, 4),
                                 (48, 80), 2, n_samples=3)
    assert got["t"].shape == (4, 3 * 48, 80)
    assert int(got["hit"][1:].sum()) > 0
    _assert_banks_match(got, want, 0)


_WAVEFRONT_CASES = {
    "sphere_on_floor": ("demo", False, {}),
    "csg_nee_rr": ("csg", True, dict(rr_start_bounce=1)),
    "all_materials_nee_rr": ("all_materials", True, dict(rr_start_bounce=1)),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_WAVEFRONT_CASES))
def test_record_wavefront_kernel_matches_plain(cuda_device, case):
    """The wavefront recorder against its plain version on the sample-
    folded planes of a patch (2 samples), one launch; then against the
    mega recorder (kernel #5) on the rays of one sample."""
    name, nee, extra = _WAVEFRONT_CASES[case]
    scene = _paths_scene(name)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_bounces=4, relax_omega=1.9,
                       normal_taps=4, **extra)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    px, py, sample, eye, d = integrator.spp_rays(cfg, corners, (8, 4),
                                                 (48, 80), 2, 2)
    launches = march.RECORD_WAVEFRONT.launches
    got = trace_record_wavefront(scene, params, cfg, eye, d, px, py, sample,
                                 direct_light=nee)
    torch.cuda.synchronize()
    assert march.RECORD_WAVEFRONT.launches == launches + 1
    want = record_wavefront_plain(scene, params, cfg, eye, d, px, py, sample,
                                  direct_light=nee)
    assert int(got["hit"].sum()) > 0
    _assert_banks_match(got, want, 0)
    px, py, sample, eye, d = integrator.spp_rays(cfg, corners, (8, 4),
                                                 (48, 80), 2, 1)
    wave = trace_record_wavefront(scene, params, cfg, eye, d, px, py, sample,
                                  direct_light=nee)
    mega = trace_record_fused(scene, params, cfg, corners, (8, 4), (48, 80),
                              2, n_samples=1, direct_light=nee)
    p = bank_parity(wave, mega, 0)
    hit = (wave["hit"] > 0) & (mega["hit"] > 0)
    assert p["decisions"] < 5e-3 and p.get("sd", 0.0) < 5e-3, p
    assert p["t"] < MAX_FRAC_OFF and p["t_later"] < LATER_FRAC_OFF, p
    assert float(torch.where(hit, (wave["t"] - mega["t"]).abs(), 0.0)[0]
                 .max()) < 5e-3


@pytest.mark.requires_cuda
def test_train_spectral_grads_kernel_banks_match_plain_banks(cuda_device):
    """One spectral step's loss and gradients (scene leaves and band rows)
    replayed over the spectral recorder's banks and over its plain
    version's, and with `march_fused` against the plain march."""
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    scene, params, mats = spectral_demo(cuda_device)
    cfg = RenderConfig(width=64, height=48, max_bounces=3, relax_omega=1.9,
                       normal_taps=4)
    corners = Camera(aspect=64 / 48).corner_rays_flat(cuda_device)
    target = torch.full((48, 64, 3), 0.1, device=cuda_device)
    kw = dict(spp=2, sample0=4)
    banks = [f(scene, params, mats, cfg, corners, (0, 0), (48, 64), 4,
               n_samples=2)
             for f in (trace_record_fused_spectral, record_spectral_plain)]
    pairs = [[train_grads_spectral_sharded(
                scene, params, mats, cfg, corners, target,
                march_impl="recorded", recorded=b, **kw) for b in banks],
             [train_grads_spectral_sharded(scene, params, mats, cfg, corners,
                                           target, march_impl=m, **kw)
              for m in ("fused", "oracle")]]
    for (loss, grads, bands), (want_loss, want_grads, want_bands) in pairs:
        assert bool(torch.isfinite(loss))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        assert all(float(b.abs().sum()) > 0.0 for b in want_bands)
        for g, w in zip(param_leaves(grads) + list(bands),
                        param_leaves(want_grads) + list(want_bands)):
            if w.numel():
                tol = 1e-3 * max(1e-6, float(w.abs().max()))
                assert float((g - w).abs().max()) <= tol, (g, w)
