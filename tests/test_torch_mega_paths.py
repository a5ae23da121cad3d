"""Port parity, the RGB megakernel schedule without NEE: the port's eager
`trace_mega_paths` against the JAX package's, run as plain jnp (jitted),
on the builtins and scene files the RGB path renders.

Without NEE a pixel is a product of material constants (and of the
roulette's 1/p), so it matches or a path flipped topology (a 1-ulp
difference of sqrt, sin/cos or rsqrt moving a hit, a mix select or a
scatter decision).  The bar counts flipped paths: fewer than 1e-3 of the
values off by more than 1e-5, the bar the JAX package sets for its own
kernel.  Measured on these inputs: 0 values off in every case.  (A
material whose colour is computed at the hit, as the all-materials scene's
fresnel tint is, is float math: that scene is held to the NEE bar in
test_torch_mega_nee.py.)
"""
import numpy as np
import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, frac_off
from _torch_paths import EXACT, PRODUCTION, STRICT, trace_pair

from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin

_CORNELL_CAM = dict(eye=(0, 2, 5.4), direction=(0, 0, -1))
_SIMPLE_CAM = dict(eye=(0.0, 1.0, -4.0))

_CASES = [
    ("sphere_on_floor", STRICT, {}, None),
    ("sphere_on_floor", PRODUCTION, {}, None),
    ("cornell", STRICT, dict(rr_start_bounce=1), _CORNELL_CAM),
    ("glass_demo", STRICT, {}, None),
    ("volume_demo", STRICT, {}, None),
    ("simple.scene", STRICT, {}, _SIMPLE_CAM),
    ("material_test.scene", STRICT, {}, None),
    ("csg_demo", EXACT, {}, None),
]
_IDS = ["sphere_on_floor-strict", "sphere_on_floor-production", "cornell-rr",
        "glass_demo", "volume_demo", "simple", "material_test",
        "csg_demo-exact_normal"]


@pytest.mark.parametrize("name,knobs,extra,cam", _CASES, ids=_IDS)
def test_trace_mega_paths_matches_jax(name, knobs, extra, cam):
    """32x32, 2 samples, 4 bounces, 192 steps; frac off measured 0.0."""
    want, got = trace_pair(name, knobs, n_samples=2, cam=cam, **extra)
    assert np.isfinite(got).all() and got.mean() > 0.0
    assert frac_off(want, got) < MAX_FRAC_OFF


def test_russian_roulette_fires():
    """The roulette changes the port's cornell image (it is not a no-op;
    the case above holds it to JAX)."""
    scene = tbuiltin.cornell()
    params = scene.init_params("cpu")
    cfg = TCfg(width=16, height=16, max_steps=192, max_bounces=4,
               max_dist=100.0)
    corners = TCamera(aspect=1.0, **_CORNELL_CAM).corner_rays_flat("cpu")
    rr, off = (tmarch.render_fused(scene, params, cfg.replace(
        rr_start_bounce=k), corners, 2, march_unroll=4) for k in (1, -1))
    assert not torch.equal(rr, off)
