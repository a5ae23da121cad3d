"""Port parity, spectral inverse rendering: the soft band filter
`_apply_band_soft`, the wavefront transport `trace_spectral` and the
differentiable forward `render_patch_spp_spectral(differentiable=True)`
against the JAX package.

Bars.  `_apply_band_soft`: values and gradients to 1e-6 relative
(`torch.sigmoid` and XLA:CPU's logistic may differ by an ulp).  The
non-differentiable transport: the image bar of tests/test_kernels.py
(fewer than 1e-3 of the values off by more than 1e-5).  The soft replay:
the loss sum(c^2) to rtol 1e-5 and the gradient of every scene leaf and
band row to 1e-4 * max|g| of the leaf; the JAX side's gradients come from
its "oracle" march (which tests/test_diff.py holds equal to "recorded"),
so no `jax.grad` runs through an interpret-mode kernel.  `_lookup` is a
gather in the port and a where-chain in JAX, so the band rows' gradients
are the same sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MAX_FRAC_OFF, corners_to_torch, frac_off,
                           mats_to_torch, np_tree)

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.integrator import spp_rays
from raymarchrenderer_tpu_torch.scene import (builtin as tbuiltin,
                                              param_leaves,
                                              params_from_numpy,
                                              params_replace)

_CFG = dict(width=32, height=16, max_steps=96, max_bounces=3,
            max_dist=100.0)
_SHAPE = (16, 32)
_S = 2


def _band_inputs(n=4096, seed=2):
    rs = np.random.RandomState(seed)
    wl = rs.uniform(360.0, 850.0, n).astype(np.float32)
    wl[::4] = 0.0                                   # unset lanes
    power = rs.uniform(0.0, 4.0, n).astype(np.float32)
    u = rs.uniform(0.0, 1.0, n).astype(np.float32)
    lo = rs.uniform(380.0, 600.0, n).astype(np.float32)
    hi = (lo + rs.uniform(5.0, 200.0, n)).astype(np.float32)
    p = rs.uniform(0.1, 8.0, n).astype(np.float32)
    w = rs.uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    return wl, power, u, lo, hi, p, w


def test_apply_band_soft_matches_jax():
    """Values, and the gradients of sum(w0 * wl + w1 * power) with respect
    to wl, min, max and power, on random lanes with a quarter unset.
    Measured: wl equal; power off on 0.3% of the lanes, by at most 1.6e-7
    relative (the sigmoid); the gradients within 1e-7 of each one's
    max."""
    wl, power, u, lo, hi, p, w = _band_inputs()
    edge = 8.0

    def jf(wl, lo, hi, p):
        a, b, absorbed = jspec._apply_band_soft(wl, jnp.asarray(power),
                                                jnp.asarray(u), lo, hi, p,
                                                edge)
        return jnp.sum(w[0] * a + w[1] * b), (a, b, absorbed)

    (_, (jwl, jpw, jabs)), jg = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(*map(jnp.asarray,
                                                     (wl, lo, hi, p)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (wl, lo, hi, p)]
    twl, tpw, tabs = tspec._apply_band_soft(xs[0], torch.from_numpy(power),
                                            torch.from_numpy(u), xs[1],
                                            xs[2], xs[3], edge)
    (torch.from_numpy(w[0]) * twl + torch.from_numpy(w[1]) * tpw).sum() \
        .backward()
    np.testing.assert_allclose(twl.detach().numpy(), np.asarray(jwl),
                               rtol=1e-6)
    np.testing.assert_allclose(tpw.detach().numpy(), np.asarray(jpw),
                               rtol=1e-6, atol=1e-30)
    assert not bool(tabs.any()) and not bool(np.asarray(jabs).any())
    for x, g in zip(xs, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(g).max()))
    unset = wl == 0.0
    assert (np.asarray(jg[1])[unset] != 0).any()   # d wl / d min = 1 - u


def _jax_case():
    js, jp, jm = jspec.spectral_demo()
    corners = JCamera(aspect=2.0).corner_rays_flat()
    return js, jp, jm, corners


def _port_case(jp, jm, corners):
    return (tbuiltin.sphere_on_floor(), params_from_numpy(np_tree(jp), "cpu"),
            mats_to_torch(jm), corners_to_torch(corners))


def test_trace_spectral_matches_jax():
    """The non-differentiable transport over the sample-folded planes of
    2 samples (oracle march, hard band filter).  Measured: 0 values
    off."""
    js, jp, jm, corners = _jax_case()
    want = jspec.render_patch_spp_spectral(
        js, jp, jm, JCfg(**_CFG), corners, (0, 0), _SHAPE, jnp.uint32(0),
        _S).stack(-1)
    ts, tp, tm, tc = _port_case(jp, jm, corners)
    got = tspec.render_patch_spp_spectral(ts, tp, tm, TCfg(**_CFG), tc,
                                          (0, 0), _SHAPE, 0, _S).stack(-1)
    assert got.shape == (16, 32, 3) and float(got.mean()) > 0.0
    assert frac_off(np.asarray(want), got.numpy()) < MAX_FRAC_OFF
    # trace_spectral directly: (wavelength, power) per lane
    px, py, sample, eye, d = spp_rays(TCfg(**_CFG), tc, (0, 0), _SHAPE, 0,
                                      _S)
    wl, power = tspec.trace_spectral(ts, tp, tm, TCfg(**_CFG), eye, d, px,
                                     py, sample)
    assert wl.shape == power.shape == (_S * 16, 32)
    assert bool(((wl == 0) | ((wl >= 380) & (wl <= 830))).all())


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss sum(c^2) and its gradients (scene leaves,
    then min_wave, max_wave, power) through the oracle march."""
    js, jp, jm, corners = _jax_case()

    def loss(fit):
        p, bands = fit
        m = jspec.SpectralMaterials(bands[0], bands[1], bands[2], jm.kind)
        c = jspec.render_patch_spp_spectral(
            js, p, m, JCfg(**_CFG), corners, (0, 0), _SHAPE, jnp.uint32(5),
            _S, differentiable=True, march_impl="oracle")
        return jnp.sum(c.stack(-1) ** 2)

    value, (gp, gb) = jax.value_and_grad(loss)(
        (jp, (jm.min_wave, jm.max_wave, jm.power)))
    return (float(value), [np.asarray(g) for g in jax.tree.leaves(gp)]
            + [np.asarray(g) for g in gb], (jp, jm, corners))


@pytest.mark.parametrize("impl", ["oracle", "recorded", "fused"])
def test_soft_replay_matches_jax(jax_grads, impl):
    """The port's differentiable forward by each march against JAX's
    oracle.  Measured, for each of the three: loss within 3.6e-7
    relative, the worst leaf within 3.6e-7 of its max|g|."""
    want_loss, want, (jp, jm, corners) = jax_grads
    ts, tp, tm, tc = _port_case(jp, jm, corners)
    leaves = [x.detach().requires_grad_(True) for x in param_leaves(tp)]
    bands = [x.detach().requires_grad_(True) for x in tm[:3]]
    mats = tspec.SpectralMaterials(*bands, tm.kind)
    c = tspec.render_patch_spp_spectral(
        ts, params_replace(tp, leaves), mats, TCfg(**_CFG), tc, (0, 0),
        _SHAPE, 5, _S, differentiable=True, march_impl=impl)
    loss = torch.sum(c.stack(-1) ** 2)
    grads = torch.autograd.grad(loss, leaves + bands, allow_unused=True)
    got = [np.zeros(tuple(x.shape), np.float32) if g is None else g.numpy()
           for g, x in zip(grads, leaves + bands)]
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(want, got):
        assert a.shape == b.shape
        scale = max(1e-6, float(np.abs(a).max(initial=0.0)))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale)
        worst = max(worst, float(np.abs(b - a).max(initial=0.0)) / scale)
    print(f"{impl}: loss rel "
          f"{abs(float(loss.detach()) - want_loss) / want_loss:.2e}, "
          f"worst leaf {worst:.2e} of max|g|")
    for g in got[-3:]:                      # the band rows are fit
        assert float(np.abs(g).sum()) > 0.0
