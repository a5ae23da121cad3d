"""Port parity, the frontends' host pieces: `core/color`, `rotate_axis` and
the camera's interactive operations, the library helpers of the core
modules (`PixelRNG`, `uniform`, `uniform_hemisphere`, `glossy_sample`,
`fresnel_schlick`, the CSG and domain operators, `sample_band`,
`band_filter`, `Light`), `utils/guards` and `utils/profiling`.

Bars: integers, bins, selections and decisions bit for bit; `color`
within 1 ulp of the JAX package where its pow is the last op, 2 where a
multiply and a subtraction follow it (`linear_to_srgb`), its u8 bit for
bit; anything through sin / cos (`rotate_axis`, the camera
poses after a seeded sequence of zoom / pan / orbit, `corner_rays`,
hemisphere and glossy directions) within 2e-6 absolute, the ulp of
XLA:CPU's sin, cos and rsqrt against numpy's or torch's; `reset`
restores the default pose exactly.  None of these compiles a JAX render.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raymarchrenderer_tpu.core import color as jcolor
from raymarchrenderer_tpu.core import rng as jrng
from raymarchrenderer_tpu.core import sampling as jsampling
from raymarchrenderer_tpu.core import sdf as jsdf
from raymarchrenderer_tpu.core import spectral as jspectral
from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.core.vecmath import rotate_axis as j_rotate
from raymarchrenderer_tpu.scene.graph import Light as JLight
from raymarchrenderer_tpu_torch.core import color as tcolor
from raymarchrenderer_tpu_torch.core import rng as trng
from raymarchrenderer_tpu_torch.core import sampling as tsampling
from raymarchrenderer_tpu_torch.core import sdf as tsdf
from raymarchrenderer_tpu_torch.core import spectral as tspectral
from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.core.vecmath import rotate_axis as t_rotate

torch.set_num_threads(1)

GEOM_TOL = 2e-6


def _f32(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, size=shape).astype(np.float32)


def _jv(a):
    return JVec3(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2]))


def _tv(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _np3(v):
    return np.stack([np.asarray(c) for c in v])


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _unit(rs, n):
    a = _f32(rs, 3, n)
    return (a / np.linalg.norm(a, axis=0)).astype(np.float32)


# -- core/color ---------------------------------------------------------------

def _color_inputs():
    c = _f32(np.random.RandomState(0), 20000, lo=-0.25, hi=1.25)
    c[:8] = [0.0, 1.0, 0.0031308, 0.04045, 1e-13, -1.0, 2.0, 0.5]
    return c


@pytest.mark.parametrize("fn", ["linear_to_srgb", "srgb_to_linear"])
def test_color_transfer_within_one_ulp(fn):
    """`srgb_to_linear` within 1 ulp (its pow is the last op); the pow of
    `linear_to_srgb` likewise, which its multiply by 1.055 and subtraction
    of 0.055 carry to at most 2 ulps of the result (measured over 1 M
    inputs: the pows an ulp apart on about 0.06% of them, the results 2
    ulps apart on 0.04%)."""
    c = _color_inputs()
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(c)))
    got = getattr(tcolor, fn)(torch.from_numpy(c)).numpy()
    assert got.dtype == np.float32
    bar = 1 if fn == "srgb_to_linear" else 2
    assert int(_ulps(want, got).max()) <= bar


def test_encode_srgb_u8_bitwise():
    c = _color_inputs()[:19992].reshape(-1, 4, 3)
    want = np.asarray(jcolor.encode_srgb_u8(jnp.asarray(c)))
    got = tcolor.encode_srgb_u8(torch.from_numpy(c))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(want, got.numpy())


def test_grayscale():
    rs = np.random.RandomState(1)
    col, ch = _f32(rs, 3, 256), _f32(rs, 3, 256, lo=0.5, hi=1.0)
    want = np.asarray(jcolor.grayscale(_jv(col), _jv(ch)))
    got = tcolor.grayscale(_tv(col), _tv(ch)).numpy()
    assert int(_ulps(want, got).max()) <= 1


# -- rotate_axis and the camera -----------------------------------------------

def test_rotate_axis_matches_jax():
    """Random unit axes, angles in [-2pi, 2pi] and points; the flipped
    cross term (the reference's handedness) included."""
    rs = np.random.RandomState(2)
    u, p = _unit(rs, 4096), _f32(rs, 3, 4096, lo=-3.0, hi=3.0)
    t = _f32(rs, 4096, lo=-2 * math.pi, hi=2 * math.pi)
    want = _np3(j_rotate(_jv(u), jnp.asarray(t), _jv(p)))
    got = _np3(t_rotate(_tv(u), torch.from_numpy(t), _tv(p)))
    np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_TOL * 3)
    # +X about +Y by +90 degrees goes to +Z (standard Rodrigues: -Z)
    q = t_rotate(TVec3(*map(torch.tensor, (0.0, 1.0, 0.0))), math.pi / 2,
                 TVec3(*map(torch.tensor, (1.0, 0.0, 0.0))))
    np.testing.assert_allclose([float(c) for c in q], [0, 0, 1], atol=1e-6)


def _ops(seed, n=24):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = rs.choice(["zoom", "pan", "orbit"])
        if kind == "zoom":
            out.append(("zoom", (float(rs.uniform(-1.0, 1.0)),)))
        elif kind == "pan":
            out.append(("pan", tuple(float(x)
                                     for x in rs.uniform(-0.5, 0.5, 2))))
        else:
            out.append(("orbit", tuple(float(x)
                                       for x in rs.uniform(-0.6, 0.6, 2))))
    return out


def _j_corners(cam):
    return np.stack([np.asarray([float(v.x), float(v.y), float(v.z)])
                     for v in cam.corner_rays()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_ops_match_jax(seed):
    """A seeded sequence of 24 zoom / pan / orbit operations at aspect 1.5:
    after each, the eye, the direction and the five corner rays within
    2e-6 of the JAX package's."""
    jc, tc = JCamera(aspect=1.5), TCamera(aspect=1.5)
    for kind, a in _ops(seed):
        getattr(jc, kind)(*a)
        getattr(tc, kind)(*a)
        np.testing.assert_allclose(tc.eye, jc.eye, rtol=0, atol=GEOM_TOL)
        np.testing.assert_allclose(tc.direction, jc.direction, rtol=0,
                                   atol=GEOM_TOL)
        got = np.stack(tc.corner_rays())
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, _j_corners(jc), rtol=0,
                                   atol=GEOM_TOL)
    np.testing.assert_array_equal(tc.corner_rays_flat("cpu").numpy(),
                                  np.stack(tc.corner_rays()))


def test_camera_reset_and_unmoved_corners():
    """`reset` (a new Camera, as the viewer's op) restores [0, 4, -6]
    exactly; an unmoved camera's corners are `corner_rays_flat`'s."""
    cam = TCamera()
    cam.orbit(0.3, -0.2)
    cam.pan(0.1, 0.2)
    cam.zoom(0.7)
    cam = TCamera(aspect=cam.aspect)
    assert cam.eye == (0.0, 4.0, -6.0)
    assert cam.direction == JCamera().direction
    flat = cam.corner_rays_flat("cpu")
    np.testing.assert_array_equal(flat.numpy(), np.stack(cam.corner_rays()))
    np.testing.assert_allclose(flat.numpy(), _j_corners(JCamera()), rtol=0,
                               atol=GEOM_TOL)


# -- the library helpers -----------------------------------------------------

def test_pixel_rng_and_uniform_bitwise():
    rs = np.random.RandomState(3)
    px = rs.randint(0, 4096, size=(8, 64)).astype(np.int32)
    py = rs.randint(0, 4096, size=(8, 64)).astype(np.int32)
    sample = rs.randint(0, 1 << 20, size=(8, 64)).astype(np.int32)
    ctr = rs.randint(0, 1 << 16, size=(8, 64)).astype(np.int32)
    for seed in (0, 7, 0xFFFFFFFF):
        j = jrng.PixelRNG(np.uint32(seed), px, py, sample)
        t = trng.PixelRNG(seed, torch.from_numpy(px), torch.from_numpy(py),
                          torch.from_numpy(sample))
        for c in (0, 5, ctr):
            tc = torch.from_numpy(c) if isinstance(c, np.ndarray) else c
            np.testing.assert_array_equal(
                np.asarray(j.bits(c)), t.bits(tc).numpy().astype(np.uint32))
            np.testing.assert_array_equal(np.asarray(j.at(c)),
                                          t.at(tc).numpy())
        np.testing.assert_array_equal(
            np.asarray(jrng.uniform(np.uint32(seed), px, py, sample, ctr)),
            trng.uniform(seed, torch.from_numpy(px), torch.from_numpy(py),
                         torch.from_numpy(sample),
                         torch.from_numpy(ctr)).numpy())


def test_uniform_hemisphere():
    rs = np.random.RandomState(4)
    u1, u2 = _f32(rs, 4096, lo=0, hi=1), _f32(rs, 4096, lo=0, hi=1)
    n = _unit(rs, 4096)
    n[:, :4] = [[0, 0, 0, 1], [1, -1, 0, 0], [0, 0, 1, 0]]  # up, down, z, x
    want = _np3(jsampling.uniform_hemisphere(jnp.asarray(u1), jnp.asarray(u2),
                                             _jv(n)))
    got = _np3(tsampling.uniform_hemisphere(torch.from_numpy(u1),
                                            torch.from_numpy(u2), _tv(n)))
    np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_TOL)
    assert np.all((got * n).sum(0) >= -1e-6)


def test_glossy_sample_and_fresnel():
    rs = np.random.RandomState(5)
    u1, u2 = _f32(rs, 4096, lo=0, hi=1), _f32(rs, 4096, lo=0, hi=1)
    wo, n = _unit(rs, 4096), _unit(rs, 4096)
    rough = _f32(rs, 4096, lo=0.0, hi=1.0)
    rough[::7] = 0.0                    # the mirror case
    want = _np3(jsampling.glossy_sample(jnp.asarray(u1), jnp.asarray(u2),
                                        _jv(wo), _jv(n), jnp.asarray(rough)))
    got = _np3(tsampling.glossy_sample(
        torch.from_numpy(u1), torch.from_numpy(u2), _tv(wo), _tv(n),
        torch.from_numpy(rough)))
    np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_TOL)
    for r in (0.0, 0.3):                # a scalar roughness
        want = _np3(jsampling.glossy_sample(jnp.asarray(u1), jnp.asarray(u2),
                                            _jv(wo), _jv(n), r))
        got = _np3(tsampling.glossy_sample(
            torch.from_numpy(u1), torch.from_numpy(u2), _tv(wo), _tv(n), r))
        np.testing.assert_allclose(got, want, rtol=0, atol=GEOM_TOL)
    c = _f32(rs, 4096, lo=-0.5, hi=1.5)
    want = np.asarray(jsampling.fresnel_schlick(jnp.asarray(c)))
    got = tsampling.fresnel_schlick(torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_csg_and_domain_ops_bitwise():
    rs = np.random.RandomState(6)
    a, b = _f32(rs, 4096), _f32(rs, 4096)
    a[:16] = b[:16]                     # ties
    ma = rs.randint(0, 8, 4096).astype(np.int32)
    mb = rs.randint(0, 8, 4096).astype(np.int32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("op_union", "op_subtract", "op_intersect"):
        np.testing.assert_array_equal(np.asarray(getattr(jsdf, name)(ja, jb)),
                                      getattr(tsdf, name)(ta, tb).numpy())
    np.testing.assert_array_equal(np.asarray(jsdf.op_round(ja, 0.25)),
                                  tsdf.op_round(ta, 0.25).numpy())
    jd, jm = jsdf.op_union_mat(ja, jnp.asarray(ma), jb, jnp.asarray(mb))
    td, tm = tsdf.op_union_mat(ta, torch.from_numpy(ma), tb,
                               torch.from_numpy(mb))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    p, t = _f32(rs, 3, 512, lo=-4, hi=4), _f32(rs, 3, 512)
    s = _f32(rs, 512, lo=0.5, hi=2.0)
    np.testing.assert_array_equal(
        _np3(jsdf.domain_translate(_jv(p), _jv(t))),
        _np3(tsdf.domain_translate(_tv(p), _tv(t))))
    np.testing.assert_array_equal(
        _np3(jsdf.domain_scale(_jv(p), jnp.asarray(s))),
        _np3(tsdf.domain_scale(_tv(p), torch.from_numpy(s))))


def test_sample_band_and_band_filter_bitwise():
    """The bins bit for bit (`tests/test_core.py`'s contract: 5 nm bins in
    [min, max)), over the gen-3 table's bands and random ones."""
    rs = np.random.RandomState(7)
    u = _f32(rs, 4096, lo=0.0, hi=1.0)
    u[:3] = [0.0, 0.999, 0.5]
    for lo, hi in ((380.0, 780.0), (390.0, 830.0), (590.0, 620.0)):
        want = np.asarray(jspectral.sample_band(jnp.asarray(u), lo, hi))
        got = tspectral.sample_band(torch.from_numpy(u), lo, hi).numpy()
        np.testing.assert_array_equal(want, got)
        assert np.all(got % 5 == 0) and got.min() >= lo and got.max() < hi
    wl = (rs.randint(70, 170, 4096) * 5.0).astype(np.float32)
    power = _f32(rs, 4096, lo=0.0, hi=2.0)
    lo, hi = _f32(rs, 4096, lo=380, hi=600), _f32(rs, 4096, lo=600, hi=830)
    mp = _f32(rs, 4096, lo=0.0, hi=1.0)
    want = jspectral.band_filter(*(jnp.asarray(x)
                                   for x in (wl, power, lo, hi, mp)))
    got = tspectral.band_filter(*(torch.from_numpy(x)
                                  for x in (wl, power, lo, hi, mp)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_light():
    from raymarchrenderer_tpu_torch.scene import Light
    assert Light(3) == Light(index=3) and Light(3).index == JLight(3).index
    with pytest.raises(Exception):
        Light(3).index = 4              # frozen, as the JAX dataclass


# -- utils/guards and utils/profiling -----------------------------------------

def _setup():
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.scene import builtin
    cfg = RenderConfig(width=32, height=32, max_steps=64, max_bounces=2,
                       max_dist=100.0)
    scene = builtin.sphere_on_floor()
    return (scene, scene.init_params("cpu"), cfg,
            TCamera(aspect=1.0).corner_rays_flat("cpu"))


@pytest.mark.parametrize("direct_light", [False, True],
                         ids=["plain", "nee"])
def test_checked_render_sample_clean_passes(direct_light):
    """As JAX tests/test_utils.py: clean parameters pass, and the image is
    the plain `render_sample`'s bit for bit."""
    from raymarchrenderer_tpu_torch.render.integrator import render_sample
    from raymarchrenderer_tpu_torch.utils import checked_render_sample
    scene, params, cfg, corners = _setup()
    err, img = checked_render_sample(scene, params, cfg, corners, 0,
                                     direct_light=direct_light)
    assert err is None and img.shape == (32, 32, 3)
    want = render_sample(scene, params, cfg, corners, 0,
                         direct_light).stack(-1)
    assert torch.equal(img, want)


def test_checked_render_sample_nan_params_raise():
    from raymarchrenderer_tpu_torch.scene.graph import (param_leaves,
                                                        params_replace)
    from raymarchrenderer_tpu_torch.utils import checked_render_sample
    scene, params, cfg, corners = _setup()
    bad = params_replace(params, [x * float("nan")
                                  for x in param_leaves(params)])
    with pytest.raises(FloatingPointError, match="NaN in"):
        checked_render_sample(scene, bad, cfg, corners, 0)
    err, img = checked_render_sample(scene, bad, cfg, corners, 0,
                                     throw=False)
    assert err.startswith("NaN in") and bool(torch.isnan(img).any())


def test_timed_block_and_compile_and_steady():
    from raymarchrenderer_tpu_torch.render.integrator import render_sample
    from raymarchrenderer_tpu_torch.utils import timed_block
    from raymarchrenderer_tpu_torch.utils.profiling import compile_and_steady
    scene, params, cfg, corners = _setup()
    out = {}
    with timed_block("render", out):
        render_sample(scene, params, cfg, corners, 0)
    with timed_block(result=out):
        pass
    assert out["render"] > 0 and out["block"] >= 0

    def fn(p):
        return render_sample(scene, p, cfg, corners, 0).stack(-1)
    first_s, steady_s, img = compile_and_steady(fn, params, reps=2)
    assert img.shape == (32, 32, 3) and first_s > 0 and steady_s > 0
