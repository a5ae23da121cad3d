"""Port parity, the spectral train step (`train --spectral`): one port
`train_step_spectral_sharded` against the JAX package's on a 1 x 1 CPU
mesh, the band clamp's gradients at its bounds, and a band edge
recovered by the port alone.

The JAX step marches with its "oracle" (no `jax.grad` through an
interpret-mode kernel); the port's step runs "oracle" and "recorded"
(which tests/test_torch_spectral_diff.py holds to JAX's oracle).  Bars:
the loss to rtol 1e-5, every updated scene leaf to atol 1e-6 (lr 1e-2
times the gradient bar), the band rows exactly: a sign step moves a row by
a whole 3 nm (or 0.03 of power), so a row either matches or its
gradient's sign flipped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import corners_to_torch, mats_to_torch, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.parallel import sharding as jsharding
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.parallel import sharding as tsharding
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import (params_from_numpy,
                                              params_to_numpy)

_CFG = dict(width=32, height=16, max_steps=96, max_bounces=3,
            max_dist=100.0)
_SPP, _SAMPLE0 = 2, 6


def _tie_table(jm):
    """spectral_demo's band table with the sphere's row narrowed to
    max == min + 5 (the tensor bound of the max clip); rows 0 and 1 keep
    min == 380 (the lower bound of the min clip)."""
    return jspec.SpectralMaterials(jm.min_wave,
                                   jm.max_wave.at[2].set(jm.min_wave[2] + 5.0),
                                   jm.power, jm.kind)


@pytest.fixture(scope="module")
def jax_step():
    js, jp, jm = jspec.spectral_demo()
    jm = _tie_table(jm)
    corners = JCamera(aspect=2.0).corner_rays_flat()
    target = np.random.RandomState(4).uniform(
        0.0, 0.3, (16, 32, 3)).astype(np.float32)
    mesh = jsharding.make_mesh(jsharding.ShardConfig(1, 1))
    with mesh:
        loss, new_p, new_m = jsharding.train_step_spectral_sharded(
            js, jp, jm, JCfg(**_CFG), corners, jnp.asarray(target), mesh,
            spp=_SPP, lr=1e-2, march_impl="oracle", interpret=True,
            sample0=_SAMPLE0)
    return (float(loss), [np.asarray(a) for a in jax.tree.leaves(new_p)],
            [np.asarray(a) for a in new_m[:3]], (jp, jm, corners, target))


@pytest.mark.parametrize("impl", ["oracle", "recorded"])
def test_train_step_spectral_matches_jax(jax_step, impl):
    """Measured, both marches: loss within 4.3e-7 relative, every updated
    leaf and band row equal (the ties at 380 nm and at min + 5 split
    their gradient as in JAX, or a row's sign would flip)."""
    want_loss, want_p, want_m, (jp, jm, corners, target) = jax_step
    tp = params_from_numpy(np_tree(jp), "cpu")
    tm = mats_to_torch(jm)
    loss, new_p, new_m = tsharding.train_step_spectral_sharded(
        tspec.spectral_demo("cpu")[0], tp, tm, TCfg(**_CFG),
        corners_to_torch(corners), torch.from_numpy(target), _SPP, lr=1e-2,
        march_impl=impl, sample0=_SAMPLE0)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = params_to_numpy(new_p)
    assert len(got) == len(want_p) == 14
    for a, b in zip(want_p, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    for a, b, b0 in zip(want_m, new_m[:3], tm[:3]):
        np.testing.assert_array_equal(b.numpy(), a)
        assert not np.array_equal(b.numpy(), b0.numpy())    # rows moved
    assert new_m.kind is tm.kind


def test_clamp_bands_splits_ties_like_jax():
    """`_clamp_bands` written as jnp.clip is: at a bound the gradient is
    split half and half between the value and the bound, as in JAX (a
    torch.clamp would give the value all of it)."""
    minw = np.float32([380.0, 500.0, 300.0, 825.0])
    maxw = np.float32([600.0, 505.0, 700.0, 900.0])
    power = np.float32([1e-4, 0.8, 0.0, 2.0])
    w = np.random.RandomState(1).uniform(0.5, 1.5, (3, 4)).astype(np.float32)

    def f(mn, mx, p, clamp, put):
        out = clamp(mn, mx, p)
        return sum((put(wk) * o).sum() for wk, o in zip(w, out))

    jg = jax.grad(lambda *a: f(*a, jsharding._clamp_bands, jnp.asarray),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (minw, maxw, power)))
    xs = [torch.from_numpy(a).requires_grad_(True)
          for a in (minw, maxw, power)]
    f(*xs, tsharding._clamp_bands, torch.from_numpy).backward()
    for x, g in zip(xs, jg):
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g))
    # the 380 nm tie of min_wave[0] and the power tie at 1e-4: half
    assert float(xs[0].grad[0]) == np.float32(0.5) * w[0, 0]
    assert float(xs[2].grad[0]) == np.float32(0.5) * w[2, 0]


def test_band_edge_recovery():
    """The port alone, recorded path: the target is spectral_demo with the
    sphere's band ending at 590 nm (hard filter, 32 samples); the fit
    starts at 680 nm and, 8 sign steps of 10 nm later (4 samples a step, a
    fresh batch each), has come most of the way back without overshooting
    (tests/test_diff.py's recovery test, smaller).  Measured: 680 -> 600
    nm, one step down each time."""
    scene, params, mats = tspec.spectral_demo("cpu")
    cfg = TCfg(width=64, height=16, max_steps=48, max_bounces=3,
               max_dist=100.0, relax_omega=1.9, normal_taps=4)
    corners = TCamera(aspect=4.0).corner_rays_flat("cpu")
    with torch.no_grad():
        target = tspec.render_patch_spp_spectral(
            scene, params, mats, cfg, corners, (0, 0), (16, 64), 100,
            32).stack(-1) / 32.0
    fit = tspec.SpectralMaterials(mats.min_wave,
                                  mats.max_wave.clone().index_fill_(
                                      0, torch.tensor([2]), 680.0),
                                  mats.power, mats.kind)
    p = params
    for k in range(8):
        loss, p, fit = tsharding.train_step_spectral_sharded(
            scene, p, fit, cfg, corners, target, 4, lr=1e-3,
            lr_bands_nm=10.0, march_impl="recorded", sample0=1000 + k * 4)
    end = float(fit.max_wave[2])
    assert np.isfinite(float(loss))
    assert 540.0 < end < 630.0, end
