"""Shared harness of the RGB schedule's parity tests
(`test_torch_mega_paths.py`, `test_torch_mega_nee.py`): one scene and one
knob set through the JAX package's `trace_mega_paths` (plain jnp, jitted)
and the port's, on the same seeded inputs."""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import ALL_MATERIALS_SCENE, corners_to_torch, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STRICT = dict(relax_omega=0.0, normal_taps=6), dict(
    lazy_miss=False, march_unroll=4, regen_cadence=0)
PRODUCTION = dict(relax_omega=2.0, normal_taps=4), dict(
    lazy_miss=True, march_unroll=32, regen_cadence=16)
# the exact normal (normal_taps=0: the reverse sweep of the map)
EXACT = dict(relax_omega=0.0, normal_taps=0), dict(
    lazy_miss=False, march_unroll=4, regen_cadence=0)


def two_light(b):
    """The two-light scene of tests/test_mega.py's NEE tests."""
    sb = b.SceneBuilder()
    m = sb.diffuse([0.6, 0.5, 0.4])
    g = sb.glossy([0.8, 0.8, 0.8], 0.2)
    sb.sphere(m, [0.0, 1.0, 0.0], 1.0)
    sb.sphere(g, [2.2, 0.7, 0.5], 0.7)
    sb.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    sb.light([3, 7, -3], 60.0, 0.8)
    sb.light([-4, 5, 2], 40.0, 0.5)
    sb.sky(0.05)
    return sb.build()


def scene_pair(name):
    """(JAX scene, torch scene) by builtin name, scene file or helper."""
    if name == "two_light":
        return two_light(jbuiltin), two_light(tbuiltin)
    if hasattr(tbuiltin, name):
        return getattr(jbuiltin, name)(), getattr(tbuiltin, name)()
    if name == "all_materials":
        text = ALL_MATERIALS_SCENE
    else:
        with open(os.path.join(_REPO, "data", "scenes", name)) as f:
            text = f.read()
    return jgraph.loads_scene(text), tgraph.loads_scene(text)


def trace_pair(name, knobs=STRICT, size=(32, 32), n_samples=1, sample0=1,
               cam=None, **kw):
    """(JAX image, port image) of `n_samples` paths per pixel, (H, W, 3)
    sums; `kw` takes the config extras (rr_start_bounce,
    separate_channels) and `direct_light`."""
    cfg_kw, sched = knobs
    h, w = size
    direct_light = kw.pop("direct_light", False)
    dispersion = kw.get("separate_channels", False)
    cfg = dict(width=w, height=h, max_steps=192, max_bounces=4,
               max_dist=100.0, **cfg_kw, **kw)
    js, ts = scene_pair(name)
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    corners = JCamera(aspect=w / h, **(cam or {})).corner_rays_flat()
    px, py = jgrid(w, h)
    ch = JVec3.full((h, w), 1.0, 1.0, 1.0)
    want = np.asarray(jax.jit(lambda p: jmega.trace_mega_paths(
        js, p, JCfg(**cfg), corners, px, py, jnp.uint32(sample0), ch,
        n_samples=n_samples, shade_gate=0.0, dispersion=dispersion,
        direct_light=direct_light, **sched).stack(-1))(jp))
    tx, ty = tgrid(w, h, "cpu")
    got = tmega.trace_mega_paths(
        ts, tp, TCfg(**cfg), corners_to_torch(corners), tx, ty, sample0,
        n_samples=n_samples, dispersion=dispersion,
        direct_light=direct_light, **sched).stack(-1).numpy()
    return want, got
