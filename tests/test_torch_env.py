"""Port parity, the skies' pieces: the .hdr codec, `atan2_poly`, the SH
sky (`core/sh.py`), `prefilter_env`, `Scene.sky` / `Scene.sky_uv` in the
"exact", "nearest" and "mxu" lookups, and the env leaves' order, each
against the JAX package on the same numpy inputs.

Bars: the codec and the integer math bitwise; float32 elementwise chains
(atan2_poly, the SH basis, the bilinear weights) to 1 ulp-scale (rtol
1e-6 / atol 1e-7); sums in another order (the prefilter's block means)
to rtol 1e-6; the "mxu" lookup against the JAX package's (N, K)
tent-weight contraction to atol 2e-6 * max|table| (four taps against a
matrix product over every table texel: the same four non-zero weights,
summed in another order, and the tent weights 1 - |x - c| an ulp off the
taps' 1 - fx; measured 1.2e-6 * max|table| on 2 of 4096 lookups); the
exact `Scene.sky` to atol 2e-5 * max|image| (torch.atan2 and
jnp.arctan2 differ by an ulp on 16% of these directions, which moves u by
2.4e-7 and the bilinear read by up to 1.2e-5 * max|image|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)

from raymarchrenderer_tpu.core import sh as jsh
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.core.vecmath import atan2_poly as jatan2
from raymarchrenderer_tpu.io import hdr as jhdr
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.core import sh as tsh
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.core.vecmath import atan2_poly as tatan2
from raymarchrenderer_tpu_torch.io import hdr as thdr
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import param_leaves, params_from_numpy


def _image(h, w, seed=0):
    return np.random.RandomState(seed).uniform(
        0.05, 4.0, (h, w, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_hdr_round_trip_against_jax(tmp_path):
    """The port's flat encoding decodes in the JAX package to the same
    floats, the JAX package's encoding decodes in the port bitwise, and
    an RLE file (runs and literals) decodes the same in both."""
    img = _image(6, 11) * np.float32(30.0)
    port = tmp_path / "port.hdr"
    thdr.save_hdr(str(port), img)
    jax_file = tmp_path / "jax.hdr"
    jhdr.save_hdr(str(jax_file), img)
    assert port.read_bytes() == jax_file.read_bytes()
    np.testing.assert_array_equal(thdr.load_hdr(str(jax_file)),
                                  jhdr.loads_hdr(port.read_bytes()))
    # RLE: one 8-wide scanline, each component a run then literals
    line = b"\x02\x02\x00\x08"
    for c in range(4):
        line += bytes([128 + 4, 100 + c]) + bytes([4, 10, 20, 30, 40 + c])
    data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 8\n" + line
    np.testing.assert_array_equal(thdr.loads_hdr(data), jhdr.loads_hdr(data))
    assert thdr.loads_hdr(data).shape == (1, 8, 3)


def test_load_env_map_formats(tmp_path):
    """.npy and .hdr load as in the JAX package; another extension
    raises in both."""
    img = _image(4, 8)
    np.save(tmp_path / "e.npy", img)
    thdr.save_hdr(str(tmp_path / "e.hdr"), img)
    for name in ("e.npy", "e.hdr"):
        np.testing.assert_array_equal(
            thdr.load_env_map(str(tmp_path / name)),
            jhdr.load_env_map(str(tmp_path / name)))
    with pytest.raises(ValueError):
        thdr.load_env_map(str(tmp_path / "e.exr"))


def test_atan2_poly_matches_jax():
    """A grid over every quadrant with the axes, the diagonals and zeros:
    equal to the JAX package's polynomial to 1e-7, and to np.arctan2
    within its stated 1e-6 rad (2e-6 with float32 rounding), as angles
    (on the negative x axis -0.0 gives pi where np.arctan2 gives -pi)."""
    v = np.concatenate([np.linspace(-3.0, 3.0, 61),
                        [0.0, -0.0, 1e-6, -1e-6, 1e3, -1e3]]).astype(
                            np.float32)
    y, x = np.meshgrid(v, v, indexing="ij")
    got = tatan2(_t(y), _t(x)).numpy()
    want = np.asarray(jatan2(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    finite = ~((x == 0) & (y == 0))
    err = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - ref))))
    assert float(err[finite].max()) < 2e-6


def _dirs(n, seed=1):
    d = np.random.RandomState(seed).normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return d


def test_sh_eval_and_bake_match_jax():
    """sh_eval on random directions with random coefficients (some
    negative radiance, so the clamp at 0 bites), constant_coeffs,
    latlong_dirs and bake_latlong."""
    d = _dirs(4096)
    coeffs = np.random.RandomState(2).uniform(
        -0.3, 0.6, (16, 3)).astype(np.float32)
    got = tsh.sh_eval(_t(coeffs), TVec3(*map(_t, d)))
    want = jsh.sh_eval(jnp.asarray(coeffs), JVec3(*map(jnp.asarray, d)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert float(min(g.min() for g in got)) == 0.0
    np.testing.assert_array_equal(tsh.constant_coeffs(0.7),
                                  jsh.constant_coeffs(0.7))
    for g, w in zip(tsh.latlong_dirs(6, 10, "cpu"), jsh.latlong_dirs(6, 10)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(tsh.bake_latlong(coeffs, 16, 32, "cpu"),
                               jsh.bake_latlong(coeffs, 16, 32), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("shape,target", [((64, 128), (32, 64)),
                                          ((64, 128), (24, 50)),
                                          ((8, 16), (32, 64))],
                         ids=["64x128->32x64", "64x128->divisors",
                              "8x16-identity"])
def test_prefilter_env_matches_jax(shape, target):
    img = _image(*shape, seed=3)
    got = tgraph.prefilter_env(_t(img), *target).numpy()
    want = np.asarray(jgraph.prefilter_env(jnp.asarray(img), *target))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _uv(n, seed=4):
    r = np.random.RandomState(seed)
    u = r.uniform(0.0, 1.0, n).astype(np.float32)
    v = r.uniform(0.0, 1.0, n).astype(np.float32)
    # the edges: wrap in u, the clamp at the poles, texel centres
    u[:8] = [0.0, 1e-7, 0.5 / 16, 0.999999, 1.0 - 0.5 / 16, 0.25, 0.5, 0.75]
    v[:8] = [0.0, 1e-7, 0.5 / 8, 0.999999, 1.0, 1.0 - 0.5 / 8, 0.5, 0.3]
    return u, v


def _scene_pair(img, **kw):
    """(JAX scene, port scene): a ball under the env image `img`."""
    js = jbuiltin.SceneBuilder()
    ts = tbuiltin.SceneBuilder()
    for b in (js, ts):
        m = b.diffuse([0.5, 0.5, 0.5])
        b.sphere(m, [0, 1, 0], 1.0)
        b.sky(0.1)
    return js.build(env_image=img, **kw), ts.build(env_image=img, **kw)


@pytest.mark.parametrize("filt", ["linear", "nearest"])
@pytest.mark.parametrize("gather", ["exact", "mxu"])
@pytest.mark.parametrize("shape", [(8, 16), (64, 128)], ids=["8x16",
                                                             "64x128"])
def test_sky_uv_matches_jax(shape, gather, filt):
    """Scene.sky_uv at 4096 (u, v) with the wrap and pole edges.  "exact"
    (and "mxu" on the 8 x 16 image, whose table is the image itself)
    against the JAX package's gather; "mxu" on the 64 x 128 image against
    its (N, K) contraction on the 32 x 64 prefiltered table."""
    img = _image(*shape, seed=5)
    js, ts = _scene_pair(img, env_filter=filt, env_gather=gather)
    jp, tp = js.init_params(), ts.init_params("cpu")
    u, v = _uv(4096)
    got = ts.sky_uv(tp, _t(u), _t(v))
    want = js.sky_uv(jp, jnp.asarray(u), jnp.asarray(v))
    scale = float(np.abs(img).max())
    for g, w in zip(got, want):
        if gather == "exact" or filt == "nearest":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7 * scale)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=2e-6 * scale)


def test_sky_env_direction_matches_jax():
    """Scene.sky on an env image (the replay's exact atan2 path) and on an
    SH sky, at 4096 random directions."""
    img = _image(64, 128, seed=6)
    js, ts = _scene_pair(img)
    d = _dirs(4096, seed=7)
    got = ts.sky(ts.init_params("cpu"), TVec3(*map(_t, d)))
    want = js.sky(js.init_params(), JVec3(*map(jnp.asarray, d)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 * float(img.max()))
    sh = np.random.RandomState(8).uniform(-0.2, 0.5, (16, 3)).astype(
        np.float32)
    text = tbuiltin.SceneBuilder()
    text.sphere(text.diffuse([0.5, 0.5, 0.5]), [0, 1, 0], 1.0)
    jscene = jgraph.loads_scene(text.to_json(), env_sh=sh)
    tscene = tgraph.loads_scene(text.to_json(), env_sh=sh)
    assert tscene.has_sh_env and not tscene.has_env_map
    got = tscene.sky(tscene.init_params("cpu"), TVec3(*map(_t, d)))
    want = jscene.sky(jscene.init_params(), JVec3(*map(jnp.asarray, d)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_env_leaves_in_jax_order():
    """An env-image scene's and an SH scene's parameter leaves, through
    params_from_numpy, come out of param_leaves in jax.tree.leaves order,
    and the texture wins over SH as in the JAX package."""
    import jax
    img = _image(4, 8)
    sh = np.ones((16, 3), np.float32)
    for kw in (dict(env_image=img), dict(env_sh=sh),
               dict(env_image=img, env_sh=sh)):
        b = tbuiltin.SceneBuilder()
        b.sphere(b.diffuse([0.5, 0.5, 0.5]), [0, 1, 0], 1.0)
        js = jgraph.loads_scene(b.to_json(), **kw)
        ts = tgraph.loads_scene(b.to_json(), **kw)
        assert (ts.has_env_map, ts.has_sh_env) == (js.has_env_map,
                                                  js.has_sh_env)
        jp = js.init_params()
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        want = jax.tree.leaves(jp)
        got = param_leaves(tp)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
