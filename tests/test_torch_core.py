"""Port parity, core: RNG, spectral colour, camera, rays, sampling.

Integer streams and the piecewise-linear colour map are bitwise equal to
the JAX package.  Float geometry agrees to a stated tolerance:
`Vec3.normalized` is 1/sqrt in the port and `lax.rsqrt` in JAX (XLA:CPU's
rsqrt is 1 ulp off a correctly rounded 1/sqrt in about a third of inputs),
and torch's sin/cos differ from XLA:CPU's by 1 ulp in a few percent.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import corners_to_torch

from raymarchrenderer_tpu.core import rng as jrng
from raymarchrenderer_tpu.core import sampling as jsampling
from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.spectral import wavelength_to_rgb as j_wl2rgb
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import raygen as jraygen
from raymarchrenderer_tpu_torch.core import rng as trng
from raymarchrenderer_tpu_torch.core import sampling as tsampling
from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.core.spectral import wavelength_to_rgb as t_wl2rgb
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.render import raygen as traygen

def _u32(rs, n):
    return rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_hash_u32_bitwise():
    rs = np.random.RandomState(0)
    a, b, c, d = (_u32(rs, 4096) for _ in range(4))
    want = np.asarray(jrng.hash_u32(a, b, c, d))
    got = _as_u32(trng.hash_u32(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(c), torch.from_numpy(d)))
    np.testing.assert_array_equal(want, got)


def test_bits_to_uniform_bitwise():
    bits = _u32(np.random.RandomState(1), 4096)
    bits[:4] = [0, 255, 256, 0xFFFFFFFF]
    want = np.asarray(jrng.bits_to_uniform(jnp.asarray(bits)))
    got = trng.bits_to_uniform(torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_rng_stream_bitwise(seed):
    """Five draws of a stream folded over per-lane sample and bounce
    arrays, through `next_bits` and `next`, with the cached stage 2."""
    rs = np.random.RandomState(2)
    px = rs.randint(0, 4096, size=(16, 64)).astype(np.int32)
    py = rs.randint(0, 4096, size=(16, 64)).astype(np.int32)
    sample = _u32(rs, (16, 64))
    bounce = rs.randint(0, 17, size=(16, 64)).astype(np.int32)
    js = jrng.RNGStream(np.uint32(seed), px, py, sample, bounce)
    ts = trng.RNGStream(seed, torch.from_numpy(px), torch.from_numpy(py),
                        torch.from_numpy(sample.astype(np.int64)),
                        torch.from_numpy(bounce))
    for k in range(5):
        if k % 2:
            np.testing.assert_array_equal(np.asarray(js.next()),
                                          ts.next().numpy())
        else:
            np.testing.assert_array_equal(np.asarray(js.next_bits()),
                                          _as_u32(ts.next_bits()))


def test_wavelength_to_rgb_bitwise():
    wl = np.concatenate([np.arange(0.0, 905.0, 5.0),
                         np.random.RandomState(3).uniform(300.0, 900.0, 2048)]
                        ).astype(np.float32)
    j = j_wl2rgb(jnp.asarray(wl))
    t = t_wl2rgb(torch.from_numpy(wl))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


_CAMERAS = [dict(aspect=1.0), dict(aspect=4.0), dict(aspect=1.5, fov=0.9),
            dict(eye=(1.0, 2.0, 3.0), direction=(0.3, -0.2, 0.7)),
            dict(eye=(0.0, 5.0, 0.0), direction=(0.0, -1.0, 0.0))]


@pytest.mark.parametrize("kw", _CAMERAS)
def test_camera_corners(kw):
    """atol 1e-7: the frame's normalisation is 1/sqrt vs rsqrt (1 ulp)."""
    want = corners_to_torch(JCamera(**kw).corner_rays_flat()).numpy()
    got = TCamera(**kw).corner_rays_flat("cpu")
    assert got.shape == (5, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_camera_look_at():
    jc, tc = JCamera(aspect=2.0), TCamera(aspect=2.0)
    jc.look_at((1.0, 0.5, 2.0))
    tc.look_at((1.0, 0.5, 2.0))
    np.testing.assert_allclose(
        tc.corner_rays_flat("cpu").numpy(),
        corners_to_torch(jc.corner_rays_flat()).numpy(), rtol=0, atol=1e-7)


def test_primary_rays():
    """Same corners, pixels and RNG stream; atol 1e-6 for the 1-ulp
    rsqrt of the final normalisation."""
    corners = JCamera(aspect=1.5).corner_rays_flat()
    jpx, jpy = jraygen.pixel_grid(48, 32)
    tpx, tpy = traygen.pixel_grid(48, 32, "cpu")
    np.testing.assert_array_equal(np.asarray(jpx), tpx.numpy())
    np.testing.assert_array_equal(np.asarray(jpy), tpy.numpy())
    want = jraygen.primary_rays(corners, jpx, jpy, 48, 32,
                                jrng.RNGStream(3, jpx, jpy, 5, 1 << 20))
    got = traygen.primary_rays(corners_to_torch(corners), tpx, tpy, 48, 32,
                               trng.RNGStream(3, tpx, tpy, 5, 1 << 20))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


def test_pixel_grid_origin():
    px, py = traygen.pixel_grid(5, 3, "cpu", origin_xy=(10, 20))
    assert px.dtype == torch.int32 and px.shape == (3, 5)
    assert px[0].tolist() == [10, 11, 12, 13, 14]
    assert py[:, 0].tolist() == [20, 21, 22]


def test_uniform_sphere_or_hemisphere():
    """Random unit normals plus the zero normal (pass-through) and the up
    axis (degenerate basis); atol 1e-6 for 1-ulp sin/cos/rsqrt."""
    rs = np.random.RandomState(4)
    n = rs.normal(size=(3, 4096)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n[:, :8] = 0.0
    n[1, 8:16] = 1.0
    n[0, 8:16] = n[2, 8:16] = 0.0
    u1 = rs.uniform(size=4096).astype(np.float32)
    u2 = rs.uniform(size=4096).astype(np.float32)
    want = jsampling.uniform_sphere_or_hemisphere(
        jnp.asarray(u1), jnp.asarray(u2), JVec3(*(jnp.asarray(c) for c in n)))
    got = tsampling.uniform_sphere_or_hemisphere(
        torch.from_numpy(u1), torch.from_numpy(u2),
        TVec3(*(torch.from_numpy(c) for c in n)))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
