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
a direction an ulp would move, fewer than 5% off by more than 1e-4, with
no bound on the largest: a grazing ray that starts an ulp away stops at
another point of the surface (measured on csg_demo with NEE, 1.25% and
0.22, while the plain versions divided by Python numbers through torch's
CUDA product with the reciprocal; they divide as the kernels do now,
`core.vecmath.div`, and share CUDA's sinf and cosf with them).  Gradients
from kernel banks against plain banks (the same replay): loss to rtol
1e-5, every leaf to atol 1e-3 * max|g|.  The spectral recorder and the
wavefront recorder are held to the banks' bar; the wavefront recorder
also against the mega recorder (kernel #5) on the same rays, with the
bar of tests/test_diff.py:481-497 (decisions and visibility off on fewer
than 5e-3 of the entries, t on both-hit entries within 5e-3 on all but
5% of the later bounces' entries).  The deferred sky's throughput banks
and raw sums are held to the image bars, its packed (u, v) banks as
`test_defer_kernel_matches_plain` states, and its composites (and the
wavefront mode's env images) to the JAX package's env bar: fewer than
1e-3 of the values off by more than 1e-3.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (ALL_MATERIALS_SCENE, ALL_NODES_SCENE,  # noqa: F401
                           BIG_OBJECT_SCENE, LATER_FRAC_OFF, MAX_FRAC_OFF,
                           assert_nee_close, bank_parity, cuda_device,
                           frac_off, many_lights_scene)

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
# the exact normal (normal_taps=0): every kernel's ExactNormal instantiation
_EXACT = dict(_PRODUCTION, taps=0)


def _scene(name):
    return (builtin.sphere_on_floor() if name == "demo"
            else loads_scene(ALL_NODES_SCENE))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene_name", ["demo", "all_nodes"])
@pytest.mark.parametrize("knobs", [_STRICT, _PRODUCTION, _EXACT],
                         ids=["strict", "production", "exact_normal"])
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
@pytest.mark.parametrize("knobs", [_STRICT, _PRODUCTION, _EXACT],
                         ids=["strict", "production", "exact_normal"])
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
    """The kernels once held 8 lights in a fixed table and refused more
    under NEE; the light table is now staged with the scene in shared
    memory, so 12 lights with NEE render and meet the NEE bar against the
    plain version, and the render without NEE still runs."""
    scene = many_lights_scene(12)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=64, height=48, max_steps=192, max_bounces=3,
                       relax_omega=2.0)
    corners = Camera(eye=(0.0, 3.0, -7.0)).corner_rays_flat(cuda_device)
    got = march.render_fused_patch(scene, params, cfg, corners, (0, 0),
                                   (48, 64), 0, n_samples=2,
                                   direct_light=True, **_SCHED)
    px, py = pixel_grid(64, 48, cuda_device, (0, 0))
    plain = trace_mega_paths(scene, params, cfg, corners, px, py, 0,
                             n_samples=2, direct_light=True,
                             **_SCHED).stack(-1) * 0.5
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0.0
    assert_nee_close(plain.cpu().numpy(), got.cpu().numpy())
    img = march.render_fused(scene, params, cfg, corners, 0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())


_SCHED = dict(lazy_miss=True, march_unroll=32, regen_cadence=16)


def _csg_sh_scene():
    """csg_demo() under an SH sky: a DC term of 0.3 and seeded band-1..3
    coefficients."""
    from unittest import mock
    from raymarchrenderer_tpu_torch.core.sh import constant_coeffs
    with mock.patch.object(builtin.SceneBuilder, "build",
                           builtin.SceneBuilder.to_json):
        text = builtin.csg_demo()
    sh = constant_coeffs(0.3)
    sh[1:] = np.random.RandomState(2).uniform(-0.1, 0.1, (15, 3))
    return loads_scene(text, env_sh=np.asarray(sh, np.float32))


def _mega_paths_grid(scene, params, cfg, corners, origin, shape, sample0,
                     n_samples, queued):
    """`rmr_mega_paths` through ctypes on one grid, with NEE: a queue
    counter runs the persistent grid on the pixel queue, a null one a
    lane per pixel; (3, h, w)."""
    import ctypes
    args, dims, prog, data = march.paths_launch(
        scene, params, cfg, corners, origin, *shape, sample0, n_samples,
        True, 32, True, True, 16)
    out = torch.empty((*shape, 3), dtype=torch.float32,
                      device=corners.device)
    queue = march._queue(corners.device) if queued else None
    march.MEGA_PATHS.launch(
        ctypes.byref(args), ctypes.byref(dims), corners.data_ptr(),
        data.data_ptr(), prog.data_ptr(), out.data_ptr(),
        march.sky_kind(scene), None if queue is None else queue.data_ptr(),
        *march.stream_args(corners.device))
    return out.movedim(-1, 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["rgb", "spectral", "defer", "record",
                                  "record_spectral", "wavefront_spectral",
                                  "queued_const", "queued_sh"])
def test_persistent_queue_odd_frame_and_reset(cuda_device, kind):
    """The megakernels on a 37 x 53 patch (1961 pixels, not a multiple of
    32, nor of the RGB kernel's 2 x 16 queue tiles) at (11, 5) of a 96 x
    64 frame equal the whole frame's launch on those pixels bit for bit
    (a pixel's chain does not depend on the lane or the queue slot that
    runs it), and two launches back to back are equal bit for bit: the
    deferred sky, both recorders and the spectral wavefront kernel run a
    persistent grid on the pixel queue, whose counter is new for every
    launch, so every pixel is rendered again.  The queued kinds run
    `rmr_mega_paths` with the constant or the SH sky over csg_demo with
    NEE, dispersion and roulette from sample 5, at 1 and 4 samples: the
    patch on the pixel queue, the frame one lane per pixel, and the patch
    on both grids equal bit for bit."""
    queued_kind = kind.startswith("queued")
    if kind == "defer":
        scene = _env_scene("glass")
    elif kind == "queued_const":
        scene = builtin.csg_demo()
    elif kind == "queued_sh":
        scene = _csg_sh_scene()
    else:
        scene = builtin.sphere_on_floor()
    params = scene.init_params(cuda_device)
    extra = (dict(separate_channels=True, rr_start_bounce=1) if queued_kind
             else {})
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       relax_omega=1.9 if kind.startswith("record") else 2.0,
                       **extra)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    mats = band_table(scene, cuda_device)

    def launch(origin, shape, queued=True):
        """The launch's outputs as a list of (..., h, w) tensors."""
        if queued_kind:
            # the frame on one lane per pixel, the patch on the queue
            queued = queued and shape != (64, 96)
            return [_mega_paths_grid(scene, params, cfg, corners, origin,
                                     shape, 5, n, queued) for n in (1, 4)]
        if kind == "spectral":
            out = march.render_fused_spectral(
                scene, params, mats, cfg, corners, 0, n_samples=3,
                origin_xy=origin, patch_shape=shape, **_SCHED)
            return [out.movedim(-1, 0)]
        if kind == "rgb":
            out = march.render_fused_patch(scene, params, cfg, corners,
                                           origin, shape, 0, n_samples=3,
                                           **_SCHED)
            return [out.movedim(-1, 0)]
        if kind == "wavefront_spectral":
            out = march.render_fused_spectral(
                scene, params, mats, cfg, corners, 0, n_samples=3,
                origin_xy=origin, patch_shape=shape, mode="wavefront")
            return [out.movedim(-1, 0)]
        if kind == "defer":
            out, banks = march._launch_mega_defer(
                scene, params, cfg, corners, origin, *shape, 0, 3, False,
                **_SCHED)
            return [out.movedim(-1, 0), *banks]
        if kind == "record_spectral":
            rec = trace_record_fused_spectral(scene, params, mats, cfg,
                                              corners, origin, shape, 0,
                                              n_samples=2)
            # (B, 2 * h, w), sample-folded -> (B, 2, h, w)
            return [rec[k].unflatten(1, (2, -1)) for k in sorted(rec)]
        rec = trace_record_fused(scene, params, cfg, corners, origin, shape,
                                 0, n_samples=1)
        return [rec[k] for k in sorted(rec)]

    first, second = launch((11, 5), (37, 53)), launch((11, 5), (37, 53))
    frame = launch((0, 0), (64, 96))
    torch.cuda.synchronize()
    assert first[0].shape[-2:] == (37, 53)
    assert float(first[0].abs().max()) > 0.0
    for a, b, f in zip(first, second, frame):
        assert torch.equal(a, b)
        assert torch.equal(a, f[..., 5:42, 11:64])
    if queued_kind:
        per_pixel = launch((11, 5), (37, 53), queued=False)
        torch.cuda.synchronize()
        for a, p in zip(first, per_pixel):
            assert torch.equal(a, p)


@pytest.mark.requires_cuda
def test_scene_over_shared_memory_raises_with_its_size(cuda_device):
    """A scene whose tables cannot fit a block's shared memory is refused
    before the launch, and the message gives the size: an 80-node object
    needs 7 words per register and thread for the exact normal's sweep
    (80 * 7 * 4 * 128 bytes), more than an H100 block has; with 4 taps
    its stored values fit."""
    from _torch_scenes import _big_object
    import json
    obj = _big_object(40)
    scene = loads_scene(json.dumps({
        "materials": [{"id": 0, "nodes": [{"name": "shader_diffuse",
                                           "inputs": [[0.5, 0.5, 0.5]],
                                           "outputs": ["c", "d"]}],
                       "color": "c", "dir": "d"}],
        "objects": [obj]}))
    params = scene.init_params(cuda_device)
    corners = Camera().corner_rays_flat(cuda_device)
    launches = march.MEGA_PATHS.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        march.render_fused(scene, params, RenderConfig(
            width=16, height=16, max_steps=32, max_bounces=2,
            normal_taps=0), corners, 0)
    assert march.MEGA_PATHS.launches == launches
    img = march.render_fused(scene, params, RenderConfig(
        width=16, height=16, max_steps=32, max_bounces=2), corners, 0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())


def _big_object_case(name, cuda_device):
    """(scene, params, direct_light) of the shared-memory sizing cases."""
    if name == "big_object":
        scene = loads_scene(BIG_OBJECT_SCENE)
        return scene, scene.init_params(cuda_device), False
    scene = many_lights_scene(12)
    return scene, scene.init_params(cuda_device), True


@pytest.mark.requires_cuda
@pytest.mark.parametrize("taps", [4, 0], ids=["stencil", "exact_normal"])
@pytest.mark.parametrize("name", ["big_object", "many_lights"])
def test_scene_tables_sized_from_the_program(cuda_device, name, taps):
    """A 40-node object (once over the 16-register cap) and 12 lights under
    NEE (once over the 8-light cap) in the RGB megakernel, its recorder
    and, for the object, the spectral megakernel and march_fused, each
    against its plain version; the tables are sized from the scene's
    program, above 48 KiB of shared memory for the 40-node object."""
    scene, params, nee = _big_object_case(name, cuda_device)
    cfg = RenderConfig(width=64, height=48, max_steps=192, max_bounces=3,
                       relax_omega=2.0, normal_taps=taps)
    corners = Camera(eye=(0.0, 3.0, -7.0)).corner_rays_flat(cuda_device)
    px, py = pixel_grid(64, 48, cuda_device, (0, 0))
    got = march.render_fused_patch(scene, params, cfg, corners, (0, 0),
                                   (48, 64), 0, n_samples=2,
                                   direct_light=nee, **_SCHED)
    plain = trace_mega_paths(scene, params, cfg, corners, px, py, 0,
                             n_samples=2, direct_light=nee,
                             **_SCHED).stack(-1) * 0.5
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0.0
    if nee:
        assert_nee_close(plain.cpu().numpy(), got.cpu().numpy())
    else:
        assert frac_off(plain.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF
    rcfg = RenderConfig(width=64, height=48, max_bounces=3, relax_omega=1.9,
                        normal_taps=taps)
    _assert_banks_match(
        trace_record_fused(scene, params, rcfg, corners, (0, 0), (48, 64),
                           0, n_samples=1, direct_light=nee),
        record_plain(scene, params, rcfg, corners, (0, 0), (48, 64), 0,
                     n_samples=1, direct_light=nee), bounce_axis=0)
    if nee:
        return
    mats = band_table(scene, cuda_device)
    got = march.render_fused_spectral(scene, params, mats, cfg, corners, 0,
                                      n_samples=2, **_SCHED)
    plain = trace_mega_spectral(scene, params, mats, cfg, corners, px, py, 0,
                                n_samples=2, **_SCHED).stack(-1) * 0.5
    assert frac_off(plain.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF
    o = Vec3(*(torch.full((48, 64), v, device=cuda_device)
               for v in (0.0, 3.0, -7.0)))
    d = Vec3(px.float() / 64.0 - 0.5, py.float() / -48.0, torch.ones_like(
        px, dtype=torch.float32)).normalized()
    act = torch.ones((48, 64), dtype=torch.bool, device=cuda_device)
    t, mid, hit = march.march_fused(scene, params, cfg, o, d, 1.0, act)
    pt, pmid, phit = integrator.march(scene, params, cfg, o, d, 1.0, act)
    assert torch.equal(mid, pmid) and torch.equal(hit, phit)
    assert float((t - pt).abs().max()) < 1e-5


# (scene, direct_light, config extras, samples)
_RECORD_CASES = {
    "sphere_on_floor": ("demo", False, {}, 2),
    "csg_nee": ("csg", True, {}, 2),
    "csg_dispersion_nee_rr": ("csg", True, dict(separate_channels=True,
                                                rr_start_bounce=1), 1),
    "csg_nee_exact_normal": ("csg", True, dict(normal_taps=0), 2),
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
                       **{"normal_taps": 4, **extra})
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
@pytest.mark.parametrize("shape", [(37, 53), (1000,), (3, 5, 7)],
                         ids=["odd_plane", "one_row", "three_axes"])
def test_march_fused_ray_queue(cuda_device, shape):
    """`march_fused` on planes of rays that are no multiple of 128 (nor of
    a warp): mixed inactive lanes, a quarter inside the
    ball with dist_mult -1, a per-lane t_max (the shadow-style plane).
    Against `integrator.march` on the same planes to the banks' bar, the
    same bytes on a second launch (the queue's counter is new for every
    launch), and each ray's outputs the same bytes when it is marched
    within a larger plane (a ray does not depend on its slot or lane)."""
    scene = builtin.sphere_on_floor()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=80, height=48, max_steps=160, max_dist=100.0,
                       relax_omega=1.9)
    n = int(np.prod(shape))
    o, d, dm, act, tmax = _ray_planes(cuda_device, 48, 80, seed=9)

    def first(x):
        """The plane's first n rays, row-major, as `shape`."""
        return x.reshape(-1)[:n].reshape(shape)

    planes = (Vec3(*map(first, o)), Vec3(*map(first, d)), first(dm),
              first(act), first(tmax))
    got = march.march_fused(scene, params, cfg, *planes[:4], t_max=planes[4])
    again = march.march_fused(scene, params, cfg, *planes[:4],
                              t_max=planes[4])
    whole = march.march_fused(scene, params, cfg, o, d, dm, act, t_max=tmax)
    torch.cuda.synchronize()
    assert got[0].shape == shape
    for a, b, w in zip(got, again, whole):
        assert torch.equal(a, b)
        assert torch.equal(a.reshape(-1), w.reshape(-1)[:n])
    pt, pmid, phit = integrator.march(scene, params, cfg, *planes[:4],
                                      t_max=planes[4])
    _assert_banks_match({"t": got[0], "mid": got[1], "hit": got[2].int()},
                        {"t": pt, "mid": pmid, "hit": phit.int()})
    assert not bool(got[2][~planes[3]].any())
    assert 0 < int(got[2].sum()) < n


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,nee,taps", [("demo", False, 4),
                                          ("csg", True, 4), ("csg", True, 0)])
def test_train_grads_kernel_banks_match_plain_banks(cuda_device, name, nee,
                                                    taps):
    """One train step's loss and gradients replayed over the recorder's
    banks and over its plain version's, and with `march_fused` against
    the plain march: each leaf to atol 1e-3 * max|g|, with NEE the JAX
    package's NEE bar 2e-2 * max|g| (tests/test_diff.py:409-413); with the
    exact normal (0 taps) the replay differentiates the normal too."""
    scene = _paths_scene(name)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=64, height=48, max_bounces=3, relax_omega=1.9,
                       normal_taps=taps)
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
@pytest.mark.parametrize("taps", [4, 0])
def test_record_spectral_kernel_matches_plain(cuda_device, scene_name, taps):
    """The spectral recorder against its plain version with the card's
    knobs (unroll 32, cadence 16, lazy miss) on the same CUDA tensors: a
    patch at a non-zero origin, 3 samples from sample 2; one launch."""
    scene = _scene(scene_name)
    params = scene.init_params(cuda_device)
    mats = band_table(scene, cuda_device)
    cfg = RenderConfig(width=96, height=64, max_bounces=4, relax_omega=1.9,
                       normal_taps=taps)
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
    "csg_nee_rr_exact_normal": ("csg", True, dict(rr_start_bounce=1,
                                                  normal_taps=0)),
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
                       **{"normal_taps": 4, **extra})
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


# (planes (ph, pw), scene, NEE, config extras)
_RAY_QUEUE_CASES = {
    "odd_ray_count": ((61, 97), "csg", True, dict(rr_start_bounce=1)),
    "back_to_back": ((48, 80), "demo", False, {}),
    "max_bounces_0": ((61, 97), "csg", True, dict(max_bounces=0)),
    "two_lights_nee": ((48, 80), "lights", True, dict(rr_start_bounce=0)),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_RAY_QUEUE_CASES))
def test_record_wavefront_ray_queue(cuda_device, case):
    """The wavefront recorder's lanes on the ray queue, bank for bank
    against its plain version (max abs err 0.0): planes of 61 x 97 rays (no
    multiple of a warp), two launches back to back (the queue's counter is
    new for every launch: the same bytes twice), max_bounces 0 (no bank
    slot; the plain version records none) and NEE toward two lights."""
    shape, name, nee, extra = _RAY_QUEUE_CASES[case]
    scene = (many_lights_scene(2) if name == "lights"
             else _paths_scene(name))
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=128, height=96, **{
        "max_bounces": 4, "relax_omega": 1.9, "normal_taps": 4, **extra})
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    px, py, sample, eye, d = integrator.spp_rays(cfg, corners, (9, 5), shape,
                                                 3, 1)
    launches = march.RECORD_WAVEFRONT.launches
    runs = 2 if case == "back_to_back" else 1
    got = [trace_record_wavefront(scene, params, cfg, eye, d, px, py, sample,
                                  direct_light=nee) for _ in range(runs)]
    torch.cuda.synchronize()
    assert march.RECORD_WAVEFRONT.launches == launches + runs
    want = record_wavefront_plain(scene, params, cfg, eye, d, px, py, sample,
                                  direct_light=nee)
    n_lights = scene.n_lights if nee else 0
    slots = {"t": cfg.max_bounces, "mid": cfg.max_bounces,
             "hit": cfg.max_bounces, "sd": cfg.max_bounces * n_lights}
    for rec in got:
        assert set(rec) == set(slots) - ({"sd"} if not nee else set())
        for k, v in rec.items():
            assert tuple(v.shape) == (slots[k], *shape)
            if cfg.max_bounces == 0:
                assert k not in want
                continue
            assert v.dtype == want[k].dtype
            assert float((v.double() - want[k].double()).abs().max()) == 0.0
        if cfg.max_bounces:
            assert int(rec["hit"][0].sum()) > 0
    if runs == 2:
        assert all(torch.equal(got[0][k], got[1][k]) for k in got[0])


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


def _env_scene(kind="ball"):
    """A ball on a box under a random 16 x 32 env image ("glass": a glass
    ball; "nee": and a sphere light)."""
    img = np.random.RandomState(7).uniform(0.0, 2.0, (16, 32, 3)).astype(
        np.float32)
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.5, 0.4])
    if kind == "glass":
        b.sphere(b.glass([0.9, 0.95, 1.0], ior=1.45), [0.0, 1.0, 0.0], 1.0)
    else:
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    if kind == "nee":
        b.light([3, 7, -3], 60.0, 0.8)
    return b.build(env_image=img)


def _uv_off(want, got, live):
    """(fraction of live slots whose packed (u, v) differ, largest bin
    distance there)."""
    du = ((want >> 16) - (got >> 16)).abs()
    dv = ((want & 0xFFFF) - (got & 0xFFFF)).abs()
    off = ((du > 0) | (dv > 0))[live]
    return (float(off.float().mean()) if off.numel() else 0.0,
            int(torch.maximum(du, dv)[live].max()) if off.numel() else 0)


# (scene kind, direct_light, config extras)
_DEFER_CASES = {
    "glass": ("glass", False, {}),
    "nee": ("nee", True, {}),
    "dispersion_rr": ("glass", False, dict(separate_channels=True,
                                           rr_start_bounce=1)),
    "nee_exact_normal": ("nee", True, dict(normal_taps=0)),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_DEFER_CASES))
def test_defer_kernel_matches_plain(cuda_device, case):
    """The deferred-sky entry (MEGA_PATHS_DEFER) against
    `trace_mega_paths(defer_sky=True)` on the same CUDA tensors, 3
    samples of a patch, production knobs: the raw sum (NEE bar with NEE),
    the throughput banks (kernel bar), the composite image at the env bar
    (fewer than 1e-3 of the values off by more than 1e-3), and the packed
    (u, v) on all but 2% of the live slots, at most 16 bins apart: torch's
    CUDA sin / cos are an ulp from the kernel's `--fmad=false` build, and
    after two or three diffuse bounces of these scenes the miss direction
    has moved by up to 1e-4 of a turn (measured: 1.0-1.1% of the live
    slots, up to 7 bins; thr and the raw sums equal).  The plain version
    against itself on the CPU with sin and cos one ulp up on half their
    inputs moves these scenes' banks by 0.47-0.98% and up to 13 bins
    (test_torch_uv_witness.py); one launch."""
    kind, nee, extra = _DEFER_CASES[case]
    scene = _env_scene(kind)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       max_dist=100.0, relax_omega=2.0,
                       **{"normal_taps": 4, **extra})
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    sched = {k: _PRODUCTION[k] for k in ("lazy_miss", "march_unroll",
                                         "regen_cadence")}
    launches = march.MEGA_PATHS_DEFER.launches
    got = march._launch_mega_defer(scene, params, cfg, corners, (8, 4), 48,
                                   80, 2, 3, nee, **sched)
    torch.cuda.synchronize()
    assert march.MEGA_PATHS_DEFER.launches == launches + 1
    want = march._mega_defer_plain(scene, params, cfg, corners, (8, 4), 48,
                                   80, 2, 3, nee, **sched)
    if nee:
        assert_nee_close(want[0].cpu().numpy(), got[0].cpu().numpy())
    else:
        off = frac_off(want[0].cpu().numpy(), got[0].cpu().numpy())
        assert off < MAX_FRAC_OFF, off
    for w, g in zip(want[1][:3], got[1][:3]):
        off = frac_off(w.cpu().numpy(), g.cpu().numpy())
        assert off < MAX_FRAC_OFF, off
    live = (want[1][0] + want[1][1] + want[1][2]) > 0
    assert float(live.float().mean()) > 0.05, float(live.float().mean())
    frac, bins = _uv_off(want[1][3], got[1][3], live)
    assert frac < 2e-2 and bins <= 16, (frac, bins)
    off = frac_off(march.composite_uv(scene, params, *want).cpu().numpy(),
                   march.composite_uv(scene, params, *got).cpu().numpy(),
                   1e-3)
    assert off < MAX_FRAC_OFF, off


@pytest.mark.requires_cuda
def test_env_render_matches_plain_chunks(cuda_device):
    """render_fused_patch on an env scene, 37 samples (a chunk of 32 paths
    and a tail launch of 5), against the same chunks through the plain
    version and the same composite: the env bar (fewer than 1e-3 of the
    values off by more than 1e-3)."""
    scene = _env_scene()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=64, height=32, max_steps=96, max_bounces=3,
                       max_dist=100.0, relax_omega=2.0, normal_taps=4)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=2.0).corner_rays_flat(
        cuda_device)
    launches = march.MEGA_PATHS_DEFER.launches
    got = march.render_fused(scene, params, cfg, corners, 0, n_samples=37)
    torch.cuda.synchronize()
    assert march.MEGA_PATHS_DEFER.launches == launches + 2
    kernel = march._launch_mega_defer
    march._launch_mega_defer = march._mega_defer_plain
    try:
        want = march.render_fused(scene, params, cfg, corners, 0,
                                  n_samples=37)
    finally:
        march._launch_mega_defer = kernel
    assert frac_off(want.cpu().numpy(), got.cpu().numpy(), 1e-3) < \
        MAX_FRAC_OFF


@pytest.mark.requires_cuda
@pytest.mark.parametrize("taps", [4, 0])
def test_sh_kernel_matches_plain(cuda_device, taps):
    """The SH sky in-kernel (MEGA_PATHS with the ShSky policy) against
    trace_mega_paths on the same CUDA tensors: the kernel bar."""
    from raymarchrenderer_tpu_torch.core.sh import constant_coeffs
    sh = constant_coeffs(0.2)
    sh[1:] = np.random.RandomState(3).uniform(-0.1, 0.1, (15, 3))
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.5, 0.4])
    b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    scene = loads_scene(b.to_json(), env_sh=sh)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       max_dist=100.0, relax_omega=2.0, normal_taps=taps)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    launches = march.MEGA_PATHS.launches
    got = march.render_fused_patch(scene, params, cfg, corners, (8, 4),
                                   (48, 80), 2, n_samples=3)
    torch.cuda.synchronize()
    assert march.MEGA_PATHS.launches == launches + 1
    px, py = pixel_grid(80, 48, cuda_device, (8, 4))
    sched = {k: _PRODUCTION[k] for k in ("lazy_miss", "march_unroll",
                                         "regen_cadence")}
    plain = trace_mega_paths(scene, params, cfg, corners, px, py, 2,
                             n_samples=3, **sched).stack(-1)
    plain = plain * float(np.float32(1.0 / 3.0))
    assert frac_off(plain.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["sphere_on_floor", "csg_dispersion_nee_rr",
                                  "env", "env_dispersion_nee",
                                  "csg_dispersion_nee_rr_exact_normal",
                                  "env_nee_exact_normal"])
def test_wavefront_kernel_matches_plain(cuda_device, case):
    """The RGB wavefront entry against wavefront_paths_plain on the same
    CUDA tensors, 5 samples at the full 16 bounces (the env cases: 5 path
    slots of a bank of 8, n_valid 5); one launch.  Images and throughput
    banks at the kernel bar (NEE bar with NEE), the miss directions with
    fewer than 1e-3 of their components off by more than 1e-4."""
    extra, nee = {}, False
    taps = 0 if case.endswith("exact_normal") else 4
    if case == "sphere_on_floor":
        scene = builtin.sphere_on_floor()
    elif case.startswith("csg_dispersion_nee_rr"):
        scene, nee = builtin.csg_demo(), True
        extra = dict(separate_channels=True, rr_start_bounce=1)
    else:
        scene = _env_scene("nee" if "nee" in case else "ball")
        nee = "nee" in case
        if "dispersion" in case:
            extra = dict(separate_channels=True)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=16,
                       max_dist=100.0, relax_omega=2.0, normal_taps=taps,
                       **extra)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    k = 8 if scene.has_env_map else 0
    args = (scene, params, cfg, corners, (8, 4), 48, 80, 2, 5, nee, k == 0,
            k)
    launches = march.WAVEFRONT_PATHS.launches
    got = march._launch_wavefront_paths(*args)
    torch.cuda.synchronize()
    assert march.WAVEFRONT_PATHS.launches == launches + 1
    want = march.wavefront_paths_plain(*args)
    pairs = list(zip(want[1], got[1])) if k else []
    img_w, img_g = (want[0], got[0]) if k else (want, got)
    if nee:
        assert_nee_close(img_w.cpu().numpy(), img_g.cpu().numpy())
    else:
        assert frac_off(img_w.cpu().numpy(), img_g.cpu().numpy()) < \
            MAX_FRAC_OFF
    for w, g in pairs[:3]:
        assert frac_off(w.cpu().numpy(), g.cpu().numpy()) < MAX_FRAC_OFF
    for w, g in pairs[3:]:
        # a direction an ulp apart after a few bounces drifts by up to
        # 1e-3 on a few slots: measured 1 of 30720 components off by
        # 1.04e-3 while the plain version divided by Python numbers
        # through torch's CUDA product with the reciprocal
        off = frac_off(w.cpu().numpy(), g.cpu().numpy(), 1e-4)
        assert off < MAX_FRAC_OFF, off
    if k:
        assert float(got[1][0][5:].abs().max()) == 0.0   # untraced slots


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["sphere_on_floor", "csg_dispersion_nee_rr",
                                  "env_partial_chunk", "exact_normal",
                                  "spectral"])
def test_wavefront_lane_machine_odd_patch_and_reset(cuda_device, case):
    """The wavefront lane machines on a 37 x 53 patch (no multiple of
    their 2 x 16 queue tiles) at (11, 5) of a 96 x 64 frame: the same
    bytes as the whole frame's launch on those pixels (a pixel's chain
    does not depend on the lane or the queue slot that runs it) and as a
    second launch (the queue's counter is new for every launch), and the
    plain version's values to the bars of
    test_wavefront_kernel_matches_plain (the spectral kernel's, in
    "spectral", to test_wavefront_spectral_kernel_matches_plain's).
    "env_partial_chunk" traces 3 path slots of a bank of 8 (the last
    chunk of a render, n_valid < K) under dispersion and NEE; the untraced
    slots stay zero."""
    if case == "spectral":
        _spectral_lane_machine_odd_patch_and_reset(cuda_device)
        return
    extra, nee, k = {}, False, 0
    if case == "sphere_on_floor":
        scene = builtin.sphere_on_floor()
    elif case == "env_partial_chunk":
        scene, nee, k = _env_scene("nee"), True, 8
        extra = dict(separate_channels=True)
    else:
        scene, nee = builtin.csg_demo(), True
        extra = dict(separate_channels=case != "exact_normal",
                     rr_start_bounce=1)
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=16,
                       max_dist=100.0, relax_omega=2.0,
                       normal_taps=0 if case == "exact_normal" else 4,
                       **extra)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    n = 3

    def launch(origin, ph, pw):
        args = (scene, params, cfg, corners, origin, ph, pw, 5, n, nee,
                k == 0, k)
        out = march._launch_wavefront_paths(*args)
        return args, ([out[0].movedim(-1, 0), *out[1]] if k
                      else [out.movedim(-1, 0)])

    launches = march.WAVEFRONT_PATHS.launches
    args, first = launch((11, 5), 37, 53)
    _, second = launch((11, 5), 37, 53)
    _, frame = launch((0, 0), 64, 96)
    torch.cuda.synchronize()
    assert march.WAVEFRONT_PATHS.launches == launches + 3
    assert float(first[0].abs().max()) > 0.0
    for a, b, f in zip(first, second, frame):
        assert torch.equal(a, b)
        assert torch.equal(a, f[..., 5:42, 11:64])
    want = march.wavefront_paths_plain(*args)
    img_w = (want[0] if k else want).movedim(-1, 0).cpu().numpy()
    img_g = first[0].cpu().numpy()
    if nee:
        assert_nee_close(img_w, img_g)
    else:
        assert frac_off(img_w, img_g) < MAX_FRAC_OFF
    if k:
        for i, (w, g) in enumerate(zip(want[1], first[1:])):
            tol = 1e-5 if i < 3 else 1e-4
            assert frac_off(w.cpu().numpy(), g.cpu().numpy(), tol) < \
                MAX_FRAC_OFF
        assert float(first[1][n:].abs().max()) == 0.0   # untraced slots
        assert float(first[1][:n].abs().max()) > 0.0


def _spectral_lane_machine_odd_patch_and_reset(cuda_device):
    """The "spectral" case of test_wavefront_lane_machine_odd_patch_and_
    reset: the spectral wavefront kernel at 16 bounces, 3 samples."""
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    scene, params, mats = spectral_demo(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=16,
                       max_dist=100.0, relax_omega=2.0)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)

    def launch(origin, ph, pw):
        return march.render_fused_spectral(
            scene, params, mats, cfg, corners, 5, n_samples=3,
            origin_xy=origin, patch_shape=(ph, pw), mode="wavefront")

    launches = march.WAVEFRONT_SPECTRAL.launches
    first, second = launch((11, 5), 37, 53), launch((11, 5), 37, 53)
    frame = launch((0, 0), 64, 96)
    torch.cuda.synchronize()
    assert march.WAVEFRONT_SPECTRAL.launches == launches + 3
    assert float(first.abs().max()) > 0.0
    assert torch.equal(first, second)
    assert torch.equal(first, frame[5:42, 11:64])
    want = march.wavefront_spectral_plain(scene, params, mats, cfg, corners,
                                          5, 3, (11, 5), 37, 53)
    assert frac_off(want.cpu().numpy(), first.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bounces", [16, 0])
@pytest.mark.parametrize("taps", [4, 0])
def test_wavefront_spectral_kernel_matches_plain(cuda_device, taps, bounces):
    """The spectral wavefront entry against wavefront_spectral_plain on
    the same CUDA tensors, 4 samples of a patch at a non-zero origin, 16
    bounces; with 0 bounces no path marches (a black image: the
    wavelength stays unset)."""
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    scene, params, mats = spectral_demo(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192,
                       max_bounces=bounces, max_dist=100.0, relax_omega=2.0,
                       normal_taps=taps)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    launches = march.WAVEFRONT_SPECTRAL.launches
    got = march.render_fused_spectral(scene, params, mats, cfg, corners, 1,
                                      n_samples=4, origin_xy=(8, 4),
                                      patch_shape=(48, 80), mode="wavefront")
    torch.cuda.synchronize()
    assert march.WAVEFRONT_SPECTRAL.launches == launches + 1
    want = march.wavefront_spectral_plain(scene, params, mats, cfg, corners,
                                          1, 4, (8, 4), 48, 80)
    assert (float(got.mean()) > 0.0) == (bounces > 0)
    assert frac_off(want.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_render_impl_oracle_on_the_card(cuda_device, tmp_path, spectral):
    """`render --impl oracle` runs on the card (the plain integrators on
    CUDA tensors, launching none of the kernels) and agrees with the same
    render on the CPU at the image bar; `--impl fused` launches the
    kernel once."""
    from raymarchrenderer_tpu_torch.app import cli
    flags = ["render", "--width", "32", "--height", "24", "--spp", "2",
             "--chunk", "2", "--max-steps", "96", "--max-bounces", "3",
             "--normal-taps", "0"] + (["--spectral"] if spectral else [])
    kernel = march.MEGA_SPECTRAL if spectral else march.MEGA_PATHS
    imgs = {}
    for dev, impl in (("cuda", "oracle"), ("cpu", "oracle"),
                      ("cuda", "fused")):
        launches = kernel.launches
        args = cli.build_parser().parse_args(
            flags + ["--device", dev, "--impl", impl, "--out",
                     str(tmp_path / f"{dev}_{impl}.npy")])
        img, n, _ = cli.cmd_render(args)
        torch.cuda.synchronize()
        assert kernel.launches == launches + (impl == "fused")
        imgs[(dev, impl)] = img.cpu().numpy()
    assert frac_off(imgs[("cpu", "oracle")], imgs[("cuda", "oracle")]) < \
        MAX_FRAC_OFF
    assert float(imgs[("cuda", "fused")].mean()) > 0.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_tiles_byte_equal_full_frame(cuda_device, nee):
    """`ProgressiveRenderer` ("auto" is the kernel on the card) through a
    4 x 4 spiral of 64^2 tiles, byte-equal to one full-frame launch, and
    two endless passes, one full-frame launch each, to the running mean
    of two full-frame launches."""
    from raymarchrenderer_tpu_torch.render.tiles import ProgressiveRenderer
    scene = builtin.csg_demo() if nee else builtin.sphere_on_floor()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=256, height=256, max_steps=192, max_bounces=4,
                       relax_omega=2.0, normal_taps=4)
    corners = Camera(aspect=1.0).corner_rays_flat(cuda_device)
    march.MEGA_PATHS.launches = 0
    pr = ProgressiveRenderer(scene, params, cfg, corners, direct_light=nee)
    assert pr.impl == "fused"
    tiled = pr.render_pass(spp=4)
    assert march.MEGA_PATHS.launches == 16
    full = march.render_fused(scene, params, cfg, corners, 0, n_samples=4,
                              direct_light=nee)
    assert full.mean() > 0.0 and torch.equal(tiled, full)
    pr = ProgressiveRenderer(scene, params, cfg, corners, direct_light=nee)
    before = march.MEGA_PATHS.launches
    got = pr.endless_passes(2)
    assert march.MEGA_PATHS.launches == before + 2
    want = torch.zeros_like(got)
    for p in range(2):
        frame = march.render_fused(scene, params, cfg, corners, p,
                                   n_samples=1, direct_light=nee)
        want = (want * float(p) + frame * 1.0) / (p + 1.0)
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
def test_second_preview_pass_copies_nothing_to_the_card(cuda_device,
                                                        tmp_path):
    """Traced as the benchmark traces the preview (`rmbench.trace`), the
    first endless pass on a scene uploads its kept layout inside
    `rmr.scene_buffers`, and the second pass issues no `cudaMemcpy*`
    there: the program stays on the card and the values are gathered on
    it."""
    from rmbench import spans
    from rmbench.trace import Trace, profiled
    from raymarchrenderer_tpu_torch.render.tiles import ProgressiveRenderer
    scene = builtin.csg_demo()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=256, height=256, max_steps=192, max_bounces=4,
                       relax_omega=2.0, normal_taps=4)
    corners = Camera(aspect=1.0).corner_rays_flat(cuda_device)
    pr = ProgressiveRenderer(scene, params, cfg, corners, direct_light=True)
    copies = []
    for p in range(2):
        path = tmp_path / f"pass{p}.json"
        with profiled(path):
            pr.endless_passes(1)
        tr = Trace(path)
        assert spans.spans(tr, "rmr.scene_buffers")
        copies.append(spans.calls_inside(tr, "rmr.scene_buffers",
                                         "cudaMemcpy"))
    assert copies[0] >= 1 and copies[1] == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_resume_byte_equal_on_the_card(cuda_device, tmp_path, spectral):
    """`render --checkpoint` at 8 spp, `--resume --spp 16`: byte-equal to
    the uninterrupted 16-spp run with the same `--chunk`."""
    from raymarchrenderer_tpu_torch.app import cli
    flags = ["render", "--width", "128", "--height", "128", "--chunk", "8",
             "--relax", "2.0", "--normal-taps", "4"] + (
                 ["--spectral"] if spectral else [])
    ckpt = str(tmp_path / "r.ckpt")

    def run(spp, *extra):
        out = str(tmp_path / "o.npy")
        args = cli.build_parser().parse_args(
            flags + ["--spp", str(spp), "--out", out, *extra])
        return cli.cmd_render(args)[0]
    run(8, "--checkpoint", ckpt)
    resumed = run(16, "--checkpoint", ckpt, "--resume")
    whole = run(16)
    assert whole.mean() > 0.0 and torch.equal(resumed, whole)


@pytest.mark.requires_cuda
def test_record_exact_normal_nee_patch_at_zero(cuda_device):
    """Recorder #5 with the exact normal on csg_demo with NEE, a 128^2
    patch at (384, 512) of the 1024^2 frame, 2 samples: its banks equal
    the plain version's on the card bit for bit (the smooth union's
    reverse sweep sums its four cotangents of h in the kernel's order,
    `core.sdf.smin`)."""
    from test_torch_record_drift import record_exact
    got = record_exact(cuda_device, kernel=True)
    want = record_exact(cuda_device)
    for k in ("t", "mid", "hit", "sd"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.requires_cuda
def test_profile_counters_on_the_card_equal_the_cpu(cuda_device):
    """The work counters of `utils.metrics` computed on the card against
    the CPU's on the same small frame: the counts of the strict oracle and
    the counter-based RNG, so equal but for a lane whose march an ulp of
    the CPU's sqrt, sin or cos moves; held to the CPU tests' bar against
    JAX (0.5%, occupancy 2e-3)."""
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    from raymarchrenderer_tpu_torch.utils.metrics import (
        mega_occupancy_profile, spectral_path_profile)
    cfg = RenderConfig(width=64, height=48, max_steps=192, max_bounces=6,
                       relax_omega=2.0, normal_taps=4)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene, params, mats = spectral_demo(dev)
        corners = Camera(aspect=64 / 48).corner_rays_flat(dev)
        out[dev.type] = (
            spectral_path_profile(scene, params, mats, cfg, corners, 1,
                                  n_samples=2),
            mega_occupancy_profile(scene, params, mats, cfg, corners, 1,
                                   n_samples=4, tiles=2, bh=16, bw=32))
    (prof, occ), (prof_cpu, occ_cpu) = out["cuda"], out["cpu"]
    assert set(prof) == set(prof_cpu) and prof["hits_per_sample"] > 0.0
    for k in prof:
        assert abs(prof[k] - prof_cpu[k]) <= 5e-3 * abs(prof_cpu[k]), k
    assert abs(occ["march_occupancy"] - occ_cpu["march_occupancy"]) <= 2e-3


# (scene, direct_light, config extras) of the shade gate's card test
_GATE_CASES = {
    "sphere_on_floor": (builtin.sphere_on_floor, False, {}),
    "csg_dispersion_nee_rr": (builtin.csg_demo, True, dict(
        separate_channels=True, rr_start_bounce=1)),
    "env_nee": (lambda: _env_scene("nee"), True, {}),
    "spectral": (builtin.sphere_on_floor, False, {}),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(_GATE_CASES))
def test_gate_on_the_card_gives_gate_0(cuda_device, case):
    """`shade_gate` 1 and 32 on the card: the wrapper launches the render
    megakernel (its launch count rises by one), the same bytes as the
    gate-0 launch, and the kernel bar (NEE bar with NEE) against the
    plain version at the same gate, on a patch at a non-zero origin, 3
    samples, production knobs."""
    make, nee, extra = _GATE_CASES[case]
    scene = make()
    params = scene.init_params(cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       max_dist=100.0, relax_omega=2.0,
                       **{"normal_taps": 4, **extra})
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    sched = {k: _PRODUCTION[k] for k in ("lazy_miss", "march_unroll",
                                         "regen_cadence")}
    if case == "spectral":
        mats = band_table(scene, cuda_device)
        counter = march.MEGA_SPECTRAL

        def kernel(g):
            return march.render_fused_spectral(
                scene, params, mats, cfg, corners, 2, n_samples=3,
                origin_xy=(8, 4), patch_shape=(48, 80), shade_gate=g,
                **sched)

        def plain(g):
            px, py = pixel_grid(80, 48, cuda_device, (8, 4))
            c = trace_mega_spectral(scene, params, mats, cfg, corners, px,
                                    py, 2, n_samples=3, shade_gate=g,
                                    **sched).stack(-1)
            return c * float(np.float32(1.0 / 3.0))
    elif scene.has_env_map:
        counter = march.MEGA_PATHS_DEFER

        def kernel(g):
            return march.render_fused_patch(
                scene, params, cfg, corners, (8, 4), (48, 80), 2,
                n_samples=3, direct_light=nee, shade_gate=g, **sched)

        def plain(g):
            px, py = pixel_grid(80, 48, cuda_device, (8, 4))
            c, banks = trace_mega_paths(
                scene, params, cfg, corners, px, py, 2, n_samples=3,
                shade_gate=g, direct_light=nee, defer_sky=True, **sched)
            img = march.composite_uv(scene, params, c.stack(-1), list(banks))
            return img * float(np.float32(1.0 / 3.0))
    else:
        counter = march.MEGA_PATHS

        def kernel(g):
            return march.render_fused_patch(
                scene, params, cfg, corners, (8, 4), (48, 80), 2,
                n_samples=3, direct_light=nee, shade_gate=g, **sched)

        def plain(g):
            px, py = pixel_grid(80, 48, cuda_device, (8, 4))
            c = trace_mega_paths(scene, params, cfg, corners, px, py, 2,
                                 n_samples=3, shade_gate=g,
                                 dispersion=cfg.separate_channels,
                                 direct_light=nee, **sched).stack(-1)
            return c * float(np.float32(1.0 / 3.0))

    ref = kernel(0.0)
    for g in (1.0, 32.0):
        launches = counter.launches
        got = kernel(g)
        torch.cuda.synchronize()
        assert counter.launches == launches + 1
        assert torch.equal(got, ref), g
        want = plain(g).cpu().numpy()
        if nee:
            assert_nee_close(want, got.cpu().numpy())
        else:
            assert frac_off(want, got.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
def test_sharded_render_keeps_the_current_device(cuda_device):
    """A spectral render over (1, 2) on cuda:0 and cuda:1 (an entry point
    selects its card with cudaSetDevice): the current device afterwards is
    the one before it, so a tensor made on "cuda" stays on cuda:0, and
    the frame is the positions' slices merged (cuda:1's part against the
    same slice launched on cuda:0, byte for byte)."""
    from raymarchrenderer_tpu_torch.parallel import sharding
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    scene, params, mats = spectral_demo(cuda_device)
    cfg = RenderConfig(width=64, height=48, max_steps=512, max_bounces=16,
                       relax_omega=2.0, normal_taps=4)
    corners = Camera(aspect=64 / 48).corner_rays_flat(cuda_device)
    mesh = sharding.make_mesh(sharding.ShardConfig(1, 2),
                              [torch.device("cuda", 0),
                               torch.device("cuda", 1)])
    got = sharding.render_sharded_spectral(scene, params, mats, cfg, corners,
                                           8, mesh=mesh, sample0=8)
    assert torch.cuda.current_device() == 0
    assert torch.empty(1, device="cuda").device == torch.device("cuda", 0)
    parts = [march.render_fused_spectral(scene, params, mats, cfg, corners,
                                         s0, n_samples=4, normalize=False)
             for s0 in (8, 12)]
    assert torch.equal(got, (parts[0] + parts[1]) / 8.0)
