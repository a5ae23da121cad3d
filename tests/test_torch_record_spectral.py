"""Port parity, the spectral recorder: the port's CPU route
(`kernels.record.trace_record_fused_spectral` → `record_spectral_plain`,
the strict knobs: unroll 1, no cadence, no lazy miss test) against the
JAX package's `trace_record_fused_spectral(interpret=True)`, which keys
the same strict knobs on `interpret`.

spectral_demo at 32 x 16 pixels at origin (8, 4) of a 64 x 32 frame, 2
samples from sample 3, 3 bounces; the JAX banks are recorded once per
module.  Decisions (mid, hit) must match exactly; t to the bars of
tests/_torch_parity.py (bounce 0: 1e-6 relative on all but 5e-3 of the
entries; later bounces: fewer than 5% off by more than 1e-4, none by
2e-2).  Measured: mid and hit equal; bounce-0 t off on 1 of 1024
entries (one march step, 5.0e-4); later bounces' t off by more than 1e-4
on 1.1% of the entries, max 9.3e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_banked_t_close, corners_to_torch,
                           mats_to_torch, np_tree)

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.kernels import record as jrecord
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu_torch.kernels import record as trecord
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_W, _H, _S, _B = 32, 16, 2, 3
_ORIGIN = (8, 4)
_SAMPLE0 = 3
_CFG = dict(width=64, height=32, max_steps=96, max_bounces=_B,
            max_dist=100.0)


@pytest.fixture(scope="module")
def banks():
    """(JAX banks, port banks, port inputs): {"t", "mid", "hit"}, each
    (B, S * H, W)."""
    js, jp, jm = jspec.spectral_demo()
    corners = JCamera(aspect=2.0).corner_rays_flat()
    px, py = jgrid(_W, _H)
    want = jrecord.trace_record_fused_spectral(
        js, jp, jm, JCfg(**_CFG), corners, px + _ORIGIN[0], py + _ORIGIN[1],
        jnp.uint32(_SAMPLE0), n_samples=_S, interpret=True)
    ts = tbuiltin.sphere_on_floor()
    tp = params_from_numpy(np_tree(jp), "cpu")
    tm = mats_to_torch(jm)
    tc = corners_to_torch(corners)
    got = trecord.trace_record_fused_spectral(
        ts, tp, tm, TCfg(**_CFG), tc, _ORIGIN, (_H, _W), _SAMPLE0,
        n_samples=_S)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, (ts, tp, tm, tc))


def test_banks_match_jax(banks):
    want, got, _ = banks
    assert set(got) == set(want) == {"t", "mid", "hit"}
    for k in want:
        assert got[k].shape == want[k].shape == (_B, _S * _H, _W)
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["mid"], want["mid"])
    np.testing.assert_array_equal(got["hit"], want["hit"])
    assert_banked_t_close(want["t"], got["t"], 1)
    assert got["hit"][1:].sum() > 0         # later bounces were recorded
    assert (got["mid"][got["hit"] == 0] == -1).all()
    assert (got["t"][got["hit"] == 0] == 100.0).all()


def test_exact_normal_banks_match_jax():
    """`normal_taps=0`: the plain recorder's stacked banks against the
    JAX package's recording schedule (plain jnp, jitted, its exact normal
    a jax.vjp) at the CPU's strict knobs: decisions equal, t to the
    banked-t bars."""
    cfg = dict(_CFG, normal_taps=0)
    js, jp, jm = jspec.spectral_demo()
    corners = JCamera(aspect=2.0).corner_rays_flat()
    px, py = jgrid(_W, _H)
    want = jax.jit(lambda p: jmega.trace_mega_spectral(
        js, p, jm, JCfg(**cfg), corners, px + _ORIGIN[0], py + _ORIGIN[1],
        jnp.uint32(_SAMPLE0), n_samples=_S, march_unroll=1,
        record_banks=True)[1])(jp)
    ts = tbuiltin.sphere_on_floor()
    tx, ty = tgrid(_W, _H, "cpu", _ORIGIN)
    _, got = tmega.trace_mega_spectral(
        ts, params_from_numpy(np_tree(jp), "cpu"), mats_to_torch(jm),
        TCfg(**cfg), corners_to_torch(corners), tx, ty, _SAMPLE0,
        n_samples=_S, record_banks=True)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert_banked_t_close(want[0], got[0], _S)
    assert got[2][_S:].sum() > 0


def test_recording_continues_through_absorption(banks):
    """A recording path ends only on an emitter hit or a miss: the sphere's
    490-590 nm band absorbs the floor's out-of-band wavelengths, which
    end the render's paths, yet the banks hold bounces after such hits.
    The render's own schedule (the same lanes without record_banks) sees
    fewer later-bounce hits."""
    _, got, (ts, tp, tm, tc) = banks
    cfg = TCfg(**_CFG)
    px, py = tgrid(_W, _H, "cpu", _ORIGIN)
    work = {}
    _, stacked = tmega.trace_mega_spectral(ts, tp, tm, cfg, tc, px, py,
                                           _SAMPLE0, n_samples=_S,
                                           record_banks=True, work=work)
    folded = trecord.fold_banks(stacked, _B, _S, _H, _W, False)
    for k in got:
        np.testing.assert_array_equal(folded[k].numpy(), got[k])
    assert int(work["shade"]) == int(got["hit"].sum())
    assert int(work["march"]) > int(work["shade"])
    render_work = {}
    tmega.trace_mega_spectral(ts, tp, tm, cfg, tc, px, py, _SAMPLE0,
                              n_samples=_S, work=render_work)
    assert int(render_work["shade"]) < int(work["shade"])


def test_banks_ignore_band_values(banks):
    """One recording serves every band update: other band rows (kind kept)
    give the same banks."""
    _, got, (ts, tp, tm, tc) = banks
    other = type(tm)(tm.min_wave + 20.0, tm.max_wave - 30.0, tm.power * 0.5,
                     tm.kind)
    again = trecord.trace_record_fused_spectral(
        ts, tp, other, TCfg(**_CFG), tc, _ORIGIN, (_H, _W), _SAMPLE0,
        n_samples=_S)
    for k in got:
        np.testing.assert_array_equal(again[k].numpy(), got[k])


def test_record_knobs_are_the_devices():
    """The spectral recorder takes `record_knobs` without NEE: the
    production schedule on the card (lazy miss on), strict on the CPU."""
    assert trecord.record_knobs("cpu", False) == (1, 0, False)
    assert trecord.record_knobs(torch.device("cuda", 0), False) == (
        32, 16, True)
