"""Port parity, the wavefront modes and the SH sky on the CPU:
`render_fused_patch(mode="wavefront")` with a constant sky (the JAX
kernel's wavefront body: `trace_rgb` sample after sample), the SH sky in
both modes (`render_fused_spectral(mode="wavefront")` is in
test_torch_wavefront_spectral.py), each against the JAX package's
pure-jnp bodies on the same numpy inputs.

Bars: the kernel bar used since the port began (tests/test_kernels.py):
fewer than 1e-3 of the values off by more than 1e-5; the JAX package
holds its own wavefront kernel bitwise to its oracle
(tests/test_kernels.py:245-253), but XLA:CPU's ulp-off transcendentals
make bitwise the wrong bar across packages.  With NEE, its NEE bar.  The
SH sky, like the env image, is continuous in the miss direction, which
inherits the SDF normal's finite difference of map values that
XLA:CPU's ulp-off sqrt, sin and cos move by about 1e-5: the JAX
package's env bars (tests/test_kernels.py:84-123), fewer than 1e-3 of
the values off by more than 1e-3 and atol 5e-3 (measured: 0.6% of the
values off by more than 1e-5, none by more than 1e-3).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (MAX_FRAC_OFF, assert_nee_close, corners_to_torch,
                           frac_off, np_tree)
from _torch_paths import _REPO, scene_pair

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_ORIGIN, _SHAPE = (3, 2), (12, 20)


def _cfg(**kw):
    return dict(dict(width=24, height=16, max_steps=96, max_bounces=3,
                     max_dist=100.0), **kw)


def jax_oracle_sum(js, jp, cfg, corners, samples, direct_light):
    """The sum over `samples` of the JAX package's `render_patch` at the
    patch, (ph, pw, 3)."""
    f = jax.jit(lambda p, s: jint.render_patch(
        js, p, cfg, corners, _ORIGIN, _SHAPE, s,
        direct_light=direct_light).stack(-1))
    return sum(np.asarray(f(jp, jnp.uint32(s))) for s in samples)


@pytest.mark.parametrize("name,extra,nee", [
    ("sphere_on_floor", {}, False),
    ("cornell", dict(rr_start_bounce=1, separate_channels=True), False),
    ("csg_demo", dict(relax_omega=2.0, normal_taps=4), True),
], ids=["sphere_on_floor", "cornell-disp-rr", "csg-nee-relaxed"])
def test_wavefront_matches_jax(name, extra, nee):
    """render_fused_patch(mode="wavefront"), 3 samples from sample 2 of a
    20 x 12 patch at (3, 2), against the mean of the JAX package's
    render_patch (the wavefront kernel's body)."""
    js, ts = scene_pair(name)
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    cam = dict(eye=(0, 2, 5.4), direction=(0, 0, -1)) \
        if name == "cornell" else {}
    corners = JCamera(aspect=1.5, **cam).corner_rays_flat()
    want = jax_oracle_sum(js, jp, JCfg(**_cfg(**extra)), corners, (2, 3, 4),
                          nee) * np.float32(1.0 / 3.0)
    got = tmarch.render_fused_patch(
        ts, tp, TCfg(**_cfg(**extra)), corners_to_torch(corners), _ORIGIN,
        _SHAPE, 2, n_samples=3, direct_light=nee, mode="wavefront").numpy()
    assert np.isfinite(got).all() and got.mean() > 0.0
    if nee:
        assert_nee_close(want, got)
    else:
        assert frac_off(want, got) < MAX_FRAC_OFF


def assert_env_close(want, got):
    assert frac_off(want, got, 1e-3) < MAX_FRAC_OFF
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def _sh_scenes():
    sh = np.random.RandomState(9).uniform(-0.15, 0.45, (16, 3)).astype(
        np.float32)
    with open(os.path.join(_REPO, "data", "scenes", "default.scene")) as f:
        text = f.read()
    return jgraph.loads_scene(text, env_sh=sh), tgraph.loads_scene(
        text, env_sh=sh)


def test_sh_sky_mega_matches_jax():
    """The SH sky in the megakernel schedule (the lazy miss test and a
    cadence pass, at unroll 4 to keep XLA:CPU's compile short), 24 x 16,
    2 samples of default.scene: the port's trace_mega_paths through
    render_fused against the JAX package's trace_mega_paths."""
    js, ts = _sh_scenes()
    assert ts.has_sh_env
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    kw = _cfg(relax_omega=2.0, normal_taps=4)
    corners = JCamera(aspect=1.5).corner_rays_flat()
    px, py = jgrid(24, 16)
    ch = JVec3.full((16, 24), 1.0, 1.0, 1.0)
    want = np.asarray(jax.jit(lambda p: jmega.trace_mega_paths(
        js, p, JCfg(**kw), corners, px, py, jnp.uint32(0), ch, n_samples=2,
        shade_gate=0.0, lazy_miss=True, march_unroll=4,
        regen_cadence=2).stack(-1))(jp)) * np.float32(0.5)
    got = tmarch.render_fused(ts, tp, TCfg(**kw), corners_to_torch(corners),
                              0, n_samples=2, march_unroll=4,
                              regen_cadence=2).numpy()
    assert got.mean() > 0.0
    assert_env_close(want, got)


def test_sh_sky_wavefront_matches_jax():
    """The SH sky in wavefront mode: 3 samples of the patch against the
    JAX package's render_patch mean."""
    js, ts = _sh_scenes()
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    corners = JCamera(aspect=1.5).corner_rays_flat()
    want = jax_oracle_sum(js, jp, JCfg(**_cfg()), corners, (0, 1, 2),
                          False) * np.float32(1.0 / 3.0)
    got = tmarch.render_fused_patch(ts, tp, TCfg(**_cfg()),
                                    corners_to_torch(corners), _ORIGIN,
                                    _SHAPE, 0, n_samples=3,
                                    mode="wavefront").numpy()
    assert_env_close(want, got)
