"""Port parity, the recording megakernel's plain version:
`render.mega.trace_mega_paths(record_banks=True)` against the JAX
package's (plain jnp, jitted); the folded layouts of
`kernels.record.trace_record_fused`: tests/test_torch_record_fold.py.

32 x 16 pixels, 2 samples, 3 bounces.  The banks' decisions (mid, hit and
the NEE visibility sd) must match exactly.  Bounce 0's t is held as the
march tests hold it (tests/test_torch_march.py: 1e-6 relative, but for
fewer than 5e-3 of the entries, which may be one march step apart).  A
later bounce starts from a hit point and a direction that went through
sin, cos and rsqrt, 1 ulp apart between XLA:CPU and torch, and a ray that
starts an ulp away may stop a few march steps from the other: fewer than
5% of those entries may be off by more than 1e-4 (a tenth of hit_eps),
and none by 2e-2 (measured: at most 1.9% and 1.0e-2, on csg_demo with
NEE).  NEE runs at unroll 4: unroll 32 with NEE takes minutes to compile
on XLA:CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_banked_t_close, corners_to_torch, np_tree
from _torch_paths import EXACT, PRODUCTION, STRICT, scene_pair

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu_torch.kernels.record import trace_record_fused
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_W, _H, _S, _B = 32, 16, 2, 3
NEE_UNROLL4 = dict(relax_omega=2.0, normal_taps=4), dict(
    lazy_miss=False, march_unroll=4, regen_cadence=0)


def _cfg(cfg_kw, **kw):
    return dict(width=_W, height=_H, max_steps=192, max_bounces=_B,
                max_dist=100.0, **cfg_kw, **kw)


def _bank_pair(name, knobs, direct_light=False, **kw):
    """(JAX banks, port banks): the stacked (B*P[*L], H, W) planes."""
    cfg_kw, sched = knobs
    cfg = _cfg(cfg_kw, **kw)
    dispersion = cfg.get("separate_channels", False)
    js, ts = scene_pair(name)
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    corners = JCamera(aspect=_W / _H).corner_rays_flat()
    px, py = jgrid(_W, _H)
    ch = JVec3.full((_H, _W), 1.0, 1.0, 1.0)
    want = jax.jit(lambda p: jmega.trace_mega_paths(
        js, p, JCfg(**cfg), corners, px, py, jnp.uint32(0), ch,
        n_samples=_S, shade_gate=0.0, dispersion=dispersion,
        direct_light=direct_light, record_banks=True, **sched)[1])(jp)
    tx, ty = tgrid(_W, _H, "cpu")
    acc, got = tmega.trace_mega_paths(
        ts, tp, TCfg(**cfg), corners_to_torch(corners), tx, ty, 0,
        n_samples=_S, dispersion=dispersion, direct_light=direct_light,
        record_banks=True, **sched)
    assert acc.x.shape == (_H, _W)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _assert_banks(want, got, n_banks, paths=_S):
    assert len(want) == len(got) == n_banks
    for w, g in zip(want, got):
        assert w.shape == g.shape and w.dtype == g.dtype
    assert_banked_t_close(want[0], got[0], paths)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() > 0                     # some slot was reached
    assert (got[1][got[2] == 0] == -1).all()    # unreached: the miss values
    assert (got[0][got[2] == 0] == 100.0).all()


@pytest.mark.parametrize("knobs", [STRICT, PRODUCTION, EXACT],
                         ids=["strict", "production", "exact_normal"])
def test_banks_sphere_on_floor(knobs):
    """Measured: t, mid, hit exact at both knob sets."""
    want, got = _bank_pair("sphere_on_floor", knobs)
    assert got[0].shape == (_B * _S, _H, _W)
    _assert_banks(want, got, 3)


def test_banks_csg_nee():
    """NEE at unroll 4: the sd bank, 3.4e38 lit and 0 occluded, at slot
    ((bounce - 1) * S + sample) * L + light.  Measured: all four banks
    exact."""
    want, got = _bank_pair("csg_demo", NEE_UNROLL4, direct_light=True)
    assert got[3].shape == (_B * _S * 1, _H, _W)
    _assert_banks(want, got, 4)
    assert set(np.unique(got[3])) == {np.float32(0.0), np.float32(3.4e38)}


def test_banks_cornell_rr():
    """Russian roulette ends paths early; its decisions must match.
    Measured: exact."""
    want, got = _bank_pair("cornell", STRICT, rr_start_bounce=1,
                           rr_min_prob=0.05)
    _assert_banks(want, got, 3)


def test_banks_dispersion():
    """Three (sample, channel) paths per sample: slot b * 3S + 3s + ci.
    Measured: exact."""
    want, got = _bank_pair("glass_demo", STRICT, separate_channels=True)
    assert got[0].shape == (_B * 3 * _S, _H, _W)
    _assert_banks(want, got, 3, paths=3 * _S)


def test_wavefront_mode_refused():
    """The wavefront mode records given ray planes, which this entry point
    does not take: it raises and names the entry point that does
    (tests/test_torch_record_wavefront.py)."""
    _, ts = scene_pair("csg_demo")
    with pytest.raises(ValueError, match="trace_record_wavefront"):
        trace_record_fused(ts, ts.init_params("cpu"),
                           TCfg(width=8, height=8, max_bounces=2),
                           corners_to_torch(JCamera().corner_rays_flat()),
                           (0, 0), (8, 8), 0, mode="wavefront")
