"""Port parity, the spectral renderer's wavefront mode on the CPU:
`render_fused_spectral(mode="wavefront")` against the JAX kernel's
wavefront body (`trace_spectral` sample after sample, the splat
`wavelength_to_rgb(wl) * power`, the mean) on the same numpy inputs.

Bar: the kernel bar used since the port began, fewer than 1e-3 of the
values off by more than 1e-5 (a spectral pixel matches or one path
changed topology).
"""
import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import (MAX_FRAC_OFF, corners_to_torch, frac_off,
                           mats_to_torch, np_tree)
from _torch_paths import scene_pair

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.rng import RNGStream as JRng
from raymarchrenderer_tpu.core.spectral import wavelength_to_rgb as jw2rgb
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import eye_vec as jeye
from raymarchrenderer_tpu.render.raygen import primary_rays as jprimary
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_ORIGIN, _SHAPE = (3, 2), (12, 20)


def _cfg(**kw):
    return dict(dict(width=24, height=16, max_steps=96, max_bounces=3,
                     max_dist=100.0), **kw)


def test_spectral_wavefront_matches_jax():
    """render_fused_spectral(mode="wavefront") on the spectral demo, 4
    samples from sample 1 of the patch, against the JAX kernel's body:
    trace_spectral per sample, splat, mean."""
    js, jp, jm = jspec.spectral_demo()
    _, ts = scene_pair("sphere_on_floor")
    tp = params_from_numpy(np_tree(jp), "cpu")
    kw = _cfg(max_bounces=4)
    jcfg = JCfg(**kw)
    corners = JCamera(aspect=1.5).corner_rays_flat()
    h, w = _SHAPE
    ys, xs = np.mgrid[0:h, 0:w].astype(np.int32)
    px = jnp.asarray(xs + _ORIGIN[0])
    py = jnp.asarray(ys + _ORIGIN[1])
    e = jeye(corners)
    eye = JVec3(*(jnp.broadcast_to(v, (h, w)) for v in e))

    def body(p, m, s):
        rng = JRng(jcfg.seed, px, py, s, jnp.uint32(1 << 20))
        d = jprimary(corners, px, py, jcfg.width, jcfg.height, rng)
        wl, power = jspec.trace_spectral(js, p, m, jcfg, eye, d, px, py, s)
        return (jw2rgb(wl) * power).stack(-1)

    f = jax.jit(body)
    want = sum(np.asarray(f(jp, jm, jnp.uint32(s))) for s in (1, 2, 3, 4))
    want = want * np.float32(0.25)
    got = tmarch.render_fused_spectral(
        ts, tp, mats_to_torch(jm), TCfg(**kw), corners_to_torch(corners), 1,
        n_samples=4, origin_xy=_ORIGIN, patch_shape=_SHAPE,
        mode="wavefront").numpy()
    assert got.mean() > 0.0
    assert frac_off(want, got) < MAX_FRAC_OFF
