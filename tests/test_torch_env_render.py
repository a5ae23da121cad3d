"""Port parity, the RGB renderer under an env-image sky: the deferred sky
(`trace_rgb(defer_sky=True)`, the (u, v) pack,
`trace_mega_paths(defer_sky=True)`; `render_fused_patch`'s chunks and
composite are in test_torch_env_patch.py), each against the
JAX package's pure-jnp bodies on the same numpy inputs (the JAX package's
own tests hold its interpret-mode kernels to the same bodies).

Bars.  Returns of the deferred sky: colour and miss throughput at the
kernel bar (fewer than 1e-3 of the values off by more than 1e-5), the
miss direction to atol 1e-3 (an ulp of sin, cos, sqrt or rsqrt moves a
bounce direction, XLA:CPU against torch, and a refraction magnifies it:
measured 1.4e-4 on the glass scene; the JAX package's own tests note
4e-5 between two of its compilations).  The (u, v) pack of the same
directions: equal on all but 1e-3 of them, never more than one 16-bit bin
apart (`atan2_poly` against the JAX package's, an ulp apart, can cross a
bin edge).  The packed banks of a render: equal on all but 5% of the live
slots, never more than 4 bins apart: a bin is 1.5e-5 of a turn, and a
miss direction after a bounce inherits the SDF normal's finite difference
of map values, which XLA:CPU's ulp-off sqrt, sin and cos move by about
1e-5 (measured: 1.41% / 3 bins, 3.35% / 2, 1.34% / 3 on the three
scenes; the port against itself with sqrt, sin and cos one ulp up on
half their inputs, every throughput bank equal: 1.98% / 3, 4.96% / 3,
1.53% / 3, test_torch_uv_witness.py).  On the card, kernel against plain
version, `chip_smoke.py` holds the banks to 1e-3 and one bin (both use
CUDA's libm).  Images: the JAX package's
env bars (tests/test_kernels.py:84-123, 255-278): atol 5e-3 for a
sample's image against its oracle, fewer than 1e-3 of the values off by
more than 1e-3 for a multi-sample mean, by more than 5e-3 with
dispersion; with NEE its NEE bar.  The oracle here is the JAX package's
`render_patch` (the exact atan2 and the full-resolution bilinear read),
so the mega route's 16-bit (u, v) quantisation is inside the bar: at
most 2.4e-4 texels of these 16-wide maps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_env import PRODUCTION, STRICT, case
from _torch_parity import MAX_FRAC_OFF, assert_nee_close, frac_off

from raymarchrenderer_tpu.core.rng import RNGStream as JRng
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render.raygen import eye_vec as jeye
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu.render.raygen import primary_rays as jprimary
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid

def test_trace_rgb_defer_returns_match_jax():
    """trace_rgb(defer_sky=True) on a sample of the glass scene, 24 x 16:
    (colour, miss throughput, miss direction) against the JAX package's,
    and the composite colour + thr * sky(dir) equal to the non-deferred
    trace at the env bar."""
    js, jp, jcfg, jc, ts, tp, tcfg, tc = case("glass")
    h, w = 16, 24
    px, py = jgrid(w, h)
    rng = JRng(jcfg.seed, px, py, jnp.uint32(3), jnp.uint32(1 << 20))
    d = jprimary(jc, px, py, w, h, rng)
    e = jeye(jc)
    eye = JVec3(*(jnp.broadcast_to(v, (h, w)) for v in e))
    ones = JVec3.full((h, w), 1.0, 1.0, 1.0)
    want = jax.jit(lambda p: jint.trace_rgb(
        js, p, jcfg, eye, d, px, py, jnp.uint32(3), ones,
        defer_sky=True))(jp)
    got = tint.render_patch(ts, tp, tcfg, tc, (0, 0), (h, w), 3,
                            defer_sky=True)
    for g, wv in zip(got[:2], want[:2]):
        assert frac_off(np.asarray(wv.stack(-1)), g.stack(-1).numpy()) \
            < MAX_FRAC_OFF
    np.testing.assert_allclose(got[2].stack(-1).numpy(),
                               np.asarray(want[2].stack(-1)), atol=1e-3)
    plain = tint.render_patch(ts, tp, tcfg, tc, (0, 0), (h, w), 3)
    c, mt, md = got
    comp = (c + mt * ts.sky(tp, md)).stack(-1).numpy()
    np.testing.assert_allclose(comp, plain.stack(-1).numpy(), atol=5e-3)
    assert float(mt.stack(-1).abs().sum()) > 0.0


def _jax_mega(js, jp, cfg, corners, shape, sample0, n, dispersion,
              direct_light, knobs):
    h, w = shape
    px, py = jgrid(w, h)
    ch = JVec3.full((h, w), 1.0, 1.0, 1.0)
    c, rec = jax.jit(lambda p: jmega.trace_mega_paths(
        js, p, cfg, corners, px, py, jnp.uint32(sample0), ch, n_samples=n,
        shade_gate=0.0, dispersion=dispersion, direct_light=direct_light,
        defer_sky=True, **knobs))(jp)
    k = n * (3 if dispersion else 1)
    rec = [np.stack([np.asarray(r) for r in rec[j * k:(j + 1) * k]])
           for j in range(4)]
    return np.asarray(c.stack(-1)), rec


def assert_uv_close(want, got, live, frac=5e-2, bins=4):
    """Packed (u, v): equal on all but `frac` of the live entries, and
    never more than `bins` bins apart."""
    du = np.abs((want >> 16) - (got >> 16))
    dv = np.abs((want & 0xFFFF) - (got & 0xFFFF))
    assert float(((du > 0) | (dv > 0))[live].mean()) < frac
    assert int(du[live].max(initial=0)) <= bins
    assert int(dv[live].max(initial=0)) <= bins


def test_pack_uv_matches_jax():
    """The (u, v) pack of 20000 random unit directions plus the axes and
    the poles, against the JAX package's regen lines
    (render/mega.py:465-474 there) on the same float32 directions."""
    from raymarchrenderer_tpu.core.vecmath import atan2_poly as jatan2
    r = np.random.RandomState(11)
    d = r.normal(size=(3, 20000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    axes = np.float32([[1, -1, 0, 0, 0, 0], [0, 0, 1, -1, 0, 0],
                       [0, 0, 0, 0, 1, -1]])
    d = np.concatenate([d, axes], axis=1)
    jd = [jnp.asarray(c) for c in d]
    two_pi = jnp.float32(6.283185307179586)
    phi = jatan2(jd[2], jd[0])
    phi = jnp.where(phi < 0, phi + two_pi, phi)
    ui = jnp.clip(((phi / two_pi) * 65536.0).astype(jnp.int32), 0, 65535)
    vi = jnp.clip(((1.0 - (jd[1] * 0.5 + 0.5)) * 65536.0).astype(jnp.int32),
                  0, 65535)
    want = np.asarray((ui << 16) | vi)
    got = tmega.pack_uv(tint.Vec3(*(torch.from_numpy(c) for c in d)))
    assert got.dtype == torch.int32
    assert_uv_close(want, got.numpy(), np.ones(want.shape, bool), 1e-3, 1)


@pytest.mark.parametrize("kind,extra,knobs", [
    ("glass", {}, PRODUCTION),
    ("nee", {}, STRICT),
    ("glass", dict(separate_channels=True, rr_start_bounce=1), STRICT),
    ("nee", dict(normal_taps=0), STRICT),
], ids=["glass-production", "nee-strict", "dispersion-rr-strict",
        "nee-exact_normal"])
def test_trace_mega_paths_defer_matches_jax(kind, extra, knobs):
    """The deferred megakernel schedule, 24 x 16: the sum without the sky
    and the four banks against the JAX package's (2 samples, or 1 sample
    of 3 channel paths with dispersion); with NEE the NEE bar on the sum
    (missed paths add their NEE radiance at regen)."""
    js, jp, jcfg, jc, ts, tp, tcfg, tc = case(kind, **extra)
    disp = tcfg.separate_channels
    n = 1 if disp else 2
    nee = kind == "nee"
    want_c, want_b = _jax_mega(js, jp, jcfg, jc, (16, 24), 1, n, disp, nee,
                               knobs)
    px, py = tgrid(24, 16, "cpu")
    got_c, got_b = tmega.trace_mega_paths(
        ts, tp, tcfg, tc, px, py, 1, n_samples=n, dispersion=disp,
        direct_light=nee, defer_sky=True, **knobs)
    got_c = got_c.stack(-1).numpy()
    if nee:
        assert_nee_close(want_c, got_c)
    else:
        assert frac_off(want_c, got_c) < MAX_FRAC_OFF
    for j in range(3):
        assert frac_off(want_b[j], got_b[j].numpy()) < MAX_FRAC_OFF
    live = want_b[0] + want_b[1] + want_b[2] > 0
    assert live.mean() > 0.1
    assert_uv_close(want_b[3], got_b[3].numpy(), live)
