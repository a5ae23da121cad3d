"""Port parity, the spectral transport: band table lookup and filter, the
eager megakernel schedule, and the fused render entry point.

`_lookup` and `_apply_band` are bitwise.  For images the bar is the one
the JAX package sets for its own kernel (tests/test_kernels.py): fewer
than 1e-3 of the values off by more than 1e-5.  A spectral pixel either
matches or differs because a path changed topology (a 1-ulp difference of
sqrt, sin/cos or rsqrt moving a hit/miss or band decision), so the count
measures flipped paths.  Measured on these inputs: 0 off in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ALL_NODES_SCENE, MAX_FRAC_OFF, corners_to_torch,
                           frac_off, mats_to_torch)

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.kernels import march as jmarch
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_command
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid
from raymarchrenderer_tpu_torch.scene import graph as tgraph


def test_lookup_bitwise():
    _, _, jm = jspec.spectral_demo()
    tm = mats_to_torch(jm)
    mid = np.random.RandomState(0).randint(-2, 6, size=(32, 32))
    mid = mid.astype(np.int32)
    want = jspec._lookup(jm, jnp.asarray(mid))
    got = tspec._lookup(tm, torch.from_numpy(mid))
    for a, b in zip(want, got):
        assert b.dtype == (torch.int32 if a.dtype == jnp.int32
                           else torch.float32)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_apply_band_bitwise():
    rs = np.random.RandomState(1)
    n = 8192
    wl = (rs.randint(0, 100, n) * 5.0).astype(np.float32)
    wl[::3] = 0.0
    power = rs.uniform(0.0, 4.0, n).astype(np.float32)
    u = rs.uniform(0.0, 1.0, n).astype(np.float32)
    lo = (380.0 + rs.randint(0, 40, n) * 5.0).astype(np.float32)
    hi = (lo + rs.randint(1, 60, n) * 5.0).astype(np.float32)
    p = rs.uniform(0.1, 8.0, n).astype(np.float32)
    want = jspec._apply_band(*(jnp.asarray(a) for a in (wl, power, u, lo, hi,
                                                       p)))
    got = tspec._apply_band(*(torch.from_numpy(a) for a in (wl, power, u, lo,
                                                           hi, p)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


_STRICT = dict(relax=0.0, taps=6, lazy_miss=False, march_unroll=4,
               regen_cadence=0)
_PRODUCTION = dict(relax=2.0, taps=4, lazy_miss=True, march_unroll=32,
                   regen_cadence=16)


@pytest.mark.parametrize("knobs", [_STRICT, _PRODUCTION],
                         ids=["strict", "production"])
def test_trace_mega_spectral_matches_jax(knobs):
    """48x48, 2 samples, 4 bounces, the JAX schedule run as plain jnp."""
    kw = dict(width=48, height=48, max_steps=192, max_bounces=4,
              max_dist=100.0, relax_omega=knobs["relax"],
              normal_taps=knobs["taps"])
    sched = {k: knobs[k] for k in ("lazy_miss", "march_unroll",
                                   "regen_cadence")}
    js, jp, jm = jspec.spectral_demo()
    ts, tp, tm = tspec.spectral_demo("cpu")
    corners = JCamera(aspect=1.0).corner_rays_flat()
    px, py = jgrid(48, 48)
    want = np.asarray(jax.jit(lambda p: jmega.trace_mega_spectral(
        js, p, jm, JCfg(**kw), corners, px, py, jnp.uint32(1), n_samples=2,
        **sched).stack(-1))(jp))
    tx, ty = tgrid(48, 48, "cpu")
    got = tmega.trace_mega_spectral(
        ts, tp, tm, TCfg(**kw), corners_to_torch(corners), tx, ty, 1,
        n_samples=2, **sched).stack(-1).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert frac_off(want, got) < MAX_FRAC_OFF      # measured 0.0


def test_trace_mega_spectral_all_nodes_scene():
    """Every object node type through the schedule (strict knobs)."""
    kw = dict(width=32, height=24, max_steps=128, max_bounces=3,
              max_dist=100.0)
    js, ts = (jgraph.loads_scene(ALL_NODES_SCENE),
              tgraph.loads_scene(ALL_NODES_SCENE))
    jm = jspec.band_table(js)
    corners = JCamera(eye=(0.0, 3.0, -7.0), aspect=32 / 24).corner_rays_flat()
    px, py = jgrid(32, 24)
    want = np.asarray(jax.jit(lambda p: jmega.trace_mega_spectral(
        js, p, jm, JCfg(**kw), corners, px, py, jnp.uint32(0), n_samples=1,
        march_unroll=4).stack(-1))(js.init_params()))
    tx, ty = tgrid(32, 24, "cpu")
    got = tmega.trace_mega_spectral(
        ts, ts.init_params("cpu"), mats_to_torch(jm), TCfg(**kw),
        corners_to_torch(corners), tx, ty, 0, n_samples=1,
        march_unroll=4).stack(-1).numpy()
    assert got.mean() > 0.0
    assert frac_off(want, got) < MAX_FRAC_OFF


def test_render_fused_spectral_matches_jax_interpret():
    """The port's entry point on a CPU tensor (plain version, production
    knobs) against the JAX Pallas kernel in interpret mode, at
    tests/test_kernels.py's 128x32 frame, on a patch at a non-zero
    origin.  Interpret mode runs the JAX kernel at unroll 1 / no cadence;
    both are scheduling knobs."""
    jcfg = JCfg(width=128, height=32, spp=1, max_steps=96, max_bounces=3,
                max_dist=100.0)
    tcfg = TCfg(width=128, height=32, spp=1, max_steps=96, max_bounces=3,
                max_dist=100.0)
    js, jp, jm = jspec.spectral_demo()
    ts, tp, tm = tspec.spectral_demo("cpu")
    corners = JCamera(aspect=4.0).corner_rays_flat()
    want = np.asarray(jmarch.render_fused_spectral(
        js, jp, jm, jcfg, corners, jnp.uint32(3), n_samples=2,
        block=(8, 128), interpret=True, origin_xy=(40, 8),
        patch_shape=(16, 64)))
    launches = tmarch.MEGA_SPECTRAL.launches
    got = tmarch.render_fused_spectral(
        ts, tp, tm, tcfg, corners_to_torch(corners), 3, n_samples=2,
        origin_xy=(40, 8), patch_shape=(16, 64))
    assert tmarch.MEGA_SPECTRAL.launches == launches   # CPU: no kernel
    assert got.shape == (16, 64, 3) and got.dtype == torch.float32
    assert frac_off(want, got.numpy()) < MAX_FRAC_OFF   # measured 0.0
    # normalize=False is the raw sum, the mean times n_samples in float32
    raw = tmarch.render_fused_spectral(
        ts, tp, tm, tcfg, corners_to_torch(corners), 3, n_samples=2,
        origin_xy=(40, 8), patch_shape=(16, 64), normalize=False)
    np.testing.assert_array_equal((raw * 0.5).numpy(),
                                  got.numpy())


def test_progressive_running_mean():
    """Launches of `samples_per_launch` samples folded by the running mean
    (accum*n + chunk*k)/(n+k).  (Under
    lazy_miss a launch boundary is a schedule boundary, so one launch of
    3 samples need not equal 2 + 1 in rare lanes, as in the JAX kernel.)"""
    cfg = TCfg(width=24, height=16, spp=3, max_steps=96, max_bounces=3,
               max_dist=100.0)
    ts, tp, tm = tspec.spectral_demo("cpu")
    corners = corners_to_torch(JCamera(aspect=1.5).corner_rays_flat())
    seen = []
    img, n = tmarch.render_progressive_fused_spectral(
        ts, tp, tm, cfg, corners, samples_per_launch=2,
        callback=lambda s, st: seen.append((s, st[1])))
    assert n == 3.0 and seen == [(2, 2.0), (3, 3.0)]
    c01 = tmarch.render_fused_spectral(ts, tp, tm, cfg, corners, 0,
                                       n_samples=2)
    c2 = tmarch.render_fused_spectral(ts, tp, tm, cfg, corners, 2)
    acc = (torch.zeros_like(c01) * 0.0 + c01 * 2) / 2.0
    want = (acc * 2.0 + c2 * 1) / 3.0
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def test_knob_validation():
    ts, tp, tm = tspec.spectral_demo("cpu")
    corners = corners_to_torch(JCamera().corner_rays_flat())
    with pytest.raises(ValueError, match="divide"):
        tmarch.render_fused_spectral(ts, tp, tm, TCfg(width=8, height=8),
                                     corners, 0, march_unroll=32,
                                     regen_cadence=12)


def test_kernel_build_command():
    """The kernel is built for sm_90a without FMA contraction or fast
    math (the numerics the plain version is held to)."""
    cmd = nvcc_command("nvcc", tmarch.MEGA_SPECTRAL.source, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd
    assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert tuple(cmd[1:1 + len(NVCC_FLAGS)]) == NVCC_FLAGS
    assert tmarch.MEGA_SPECTRAL.source.name == "mega_spectral.cu"
    assert tmarch.MEGA_SPECTRAL.source.exists()
