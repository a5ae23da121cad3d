"""Port parity, the RGB megakernel schedule with next-event estimation,
dispersion and colours computed at the hit, and the fused entry point
`render_fused_patch` against the JAX Pallas kernel in interpret mode.

With NEE a pixel adds cos * power / dist^2 / pi at every hit, float math
through sqrt, sin, cos and rsqrt (1 ulp apart between torch and XLA:CPU),
so the images are close, not bitwise: the bar is the JAX package's own NEE
bar (tests/test_mega.py): fewer than 1e-3 of the values off by more than
1e-3, and rtol 5e-3 / atol 1e-3; dispersion with NEE adds its worst-lane
bound of 0.1 (tests/test_mega.py:262-267).  The measured numbers stand
beside each assert.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MAX_FRAC_OFF, assert_nee_close, corners_to_torch,
                           frac_off, np_tree)
from _torch_paths import EXACT, STRICT, scene_pair, trace_pair

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.kernels import march as jmarch
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.scene import builtin, loads_scene
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_ALL_CAM = dict(eye=(0.0, 3.0, -7.0))


@pytest.mark.parametrize("name", ["csg_demo", "two_light"])
def test_nee_matches_jax(name):
    """32x32, 2 samples (measured: csg_demo 3.7% of the values off by
    more than 1e-5, none by 1e-3, max 1.6e-4; two_light 3.9%, none by
    1e-3, max 1.1e-4)."""
    want, got = trace_pair(name, STRICT, n_samples=2, direct_light=True)
    assert got.mean() > 0.05
    assert_nee_close(want, got)
    off, _ = trace_pair(name, STRICT, n_samples=2)
    assert not np.array_equal(want, off)        # NEE contributed


def test_dispersion_with_nee_matches_jax():
    """csg_demo, one sample as three (sample, channel) paths (measured
    1.5% off by more than 1e-5, none by 1e-3, max 3.6e-5)."""
    want, got = trace_pair("csg_demo", STRICT, direct_light=True,
                           separate_channels=True)
    d = np.abs(want - got)
    assert float((d > 1e-3).mean()) < 1e-3, (d.max(), (d > 1e-3).mean())
    assert float(d.max()) < 0.1


def test_exact_normal_nee_dispersion_matches_jax():
    """`normal_taps=0` (the exact normal, the JAX side's jax.vjp inside the
    jitted schedule) with NEE, dispersion and roulette on csg_demo, 24 x
    24, one sample as three (sample, channel) paths: the NEE bar and the
    dispersion + NEE worst-lane bound of 0.1."""
    want, got = trace_pair("csg_demo", EXACT, size=(24, 24),
                           direct_light=True, separate_channels=True,
                           rr_start_bounce=1)
    assert got.mean() > 0.05
    d = np.abs(want - got)
    assert float((d > 1e-3).mean()) < 1e-3, (d.max(), (d > 1e-3).mean())
    assert float(d.max()) < 0.1


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee_rr"])
def test_all_materials_scene(nee):
    """Every material node in one scene; its floor's colour is a fresnel
    tint computed at the hit, so it is float math even without NEE
    (measured: plain 0.4% of the values off by more than 1e-5, none by
    1e-3, max 1.3e-4; with NEE and RR 2.4%, none by 1e-3, max 1.1e-4)."""
    extra = dict(direct_light=True, rr_start_bounce=1) if nee else {}
    want, got = trace_pair("all_materials", STRICT, n_samples=2,
                           cam=_ALL_CAM, **extra)
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert_nee_close(want, got)


def _fused_pair(name, nee):
    kw = dict(width=128, height=32, spp=1, max_steps=96, max_bounces=3,
              max_dist=100.0)
    js, ts = scene_pair(name)
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    corners = JCamera(aspect=4.0).corner_rays_flat()
    want = np.asarray(jmarch.render_fused_patch(
        js, jp, JCfg(**kw), corners, (40, 8), (16, 64), jnp.uint32(3),
        n_samples=2, direct_light=nee, block=(8, 128), interpret=True))
    return want, ts, tp, TCfg(**kw), corners_to_torch(corners)


@pytest.mark.parametrize("name,nee", [("sphere_on_floor", False),
                                      ("csg_demo", True)])
def test_render_fused_patch_matches_jax_interpret(name, nee):
    """The port's entry point on CPU tensors (the plain version) against
    the JAX Pallas kernel in interpret mode, on a 16x64 patch at (40, 8)
    of a 128x32 frame.  Interpret mode runs the JAX kernel at unroll 1 and
    no cadence with the lazy miss test kept, and under lazy_miss the pass
    boundaries are semantics, so the port gets the same knobs.  Measured:
    sphere_on_floor 0 values off; csg_demo with NEE 0.7% off by more than
    1e-5, none by 1e-3, max 6.6e-5."""
    want, ts, tp, cfg, corners = _fused_pair(name, nee)
    launches = tmarch.MEGA_PATHS.launches
    got = tmarch.render_fused_patch(ts, tp, cfg, corners, (40, 8), (16, 64),
                                    3, n_samples=2, direct_light=nee,
                                    march_unroll=1, regen_cadence=0)
    assert tmarch.MEGA_PATHS.launches == launches      # CPU: no kernel
    assert got.shape == (16, 64, 3) and got.dtype == torch.float32
    if nee:
        assert_nee_close(want, got.numpy())
    else:
        assert frac_off(want, got.numpy()) < MAX_FRAC_OFF
    # normalize=False is the raw sum, the mean times n_samples in float32
    raw = tmarch.render_fused_patch(ts, tp, cfg, corners, (40, 8), (16, 64),
                                    3, n_samples=2, direct_light=nee,
                                    march_unroll=1, regen_cadence=0,
                                    normalize=False)
    np.testing.assert_array_equal((raw * 0.5).numpy(), got.numpy())


def test_progressive_running_mean():
    """Launches of `samples_per_launch` samples folded by the running mean
    (accum*n + chunk*k)/(n+k), with the callback after each."""
    cfg = TCfg(width=24, height=16, spp=3, max_steps=96, max_bounces=3,
               max_dist=100.0)
    scene = builtin.csg_demo()
    params = scene.init_params("cpu")
    corners = corners_to_torch(JCamera(aspect=1.5).corner_rays_flat())
    seen = []
    img, n = tmarch.render_progressive_fused(
        scene, params, cfg, corners, samples_per_launch=2, direct_light=True,
        callback=lambda s, st: seen.append((s, st[1])))
    assert n == 3.0 and seen == [(2, 2.0), (3, 3.0)]
    c01 = tmarch.render_fused(scene, params, cfg, corners, 0, n_samples=2,
                              direct_light=True)
    c2 = tmarch.render_fused(scene, params, cfg, corners, 2,
                             direct_light=True)
    want = ((torch.zeros_like(c01) * 0.0 + c01 * 2) / 2.0 * 2.0 + c2) / 3.0
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def _tiny():
    return (TCfg(width=8, height=8, max_steps=16, max_bounces=2),
            corners_to_torch(JCamera().corner_rays_flat()))


def test_unported_paths_refused():
    """A recording with the deferred sky is refused out loud, never
    rendered as something else; the SH and env-image skies are ported
    (tests/test_torch_wavefront.py, tests/test_torch_env_render.py; an SH
    sky renders here), and so is normal_taps=0 (the exact normal,
    tests/test_torch_normal_exact.py), which renders here."""
    cfg, corners = _tiny()
    sh = loads_scene('{"materials": [], "objects": [], "environment": '
                     '{"sh": ' + str([[0.1, 0.1, 0.1]] * 16) + '}}')
    img = tmarch.render_fused(sh, sh.init_params("cpu"), cfg, corners, 0)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    scene = builtin.sphere_on_floor()
    params = scene.init_params("cpu")
    img = tmarch.render_fused(scene, params, cfg.replace(normal_taps=0),
                              corners, 0)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    px, py = pixel_grid(8, 8, "cpu")
    with pytest.raises(ValueError, match="exclusive"):
        tmega.trace_mega_paths(scene, params, cfg, corners, px, py, 0,
                               defer_sky=True, record_banks=True)


def test_knob_validation():
    cfg, corners = _tiny()
    scene = builtin.sphere_on_floor()
    with pytest.raises(ValueError, match="divide"):
        tmarch.render_fused(scene, scene.init_params("cpu"), cfg, corners, 0,
                            march_unroll=32, regen_cadence=12)
    with pytest.raises(ValueError, match="n_samples"):
        tmarch.render_fused(scene, scene.init_params("cpu"), cfg, corners, 0,
                            n_samples=0)
