"""Port parity, the wavefront recorder: the port's
`kernels.record.trace_record_wavefront` on the CPU (its plain version,
`record_wavefront_plain`) against the JAX package's
`trace_record_fused(mode="wavefront", interpret=True)` on the same ray
planes, and against the port's own megakernel-schedule recorder on the
same rays (the invariant of tests/test_diff.py:449).

Planes: the primary rays of a 32 x 16 patch at origin (4, 8), made by
the JAX package and handed to both as numpy arrays, with a per-lane
sample index drawn from a seed.  Bars against JAX: decisions (mid, hit,
the NEE visibility sd) exact; t to tests/_torch_parity.py's bars (bounce
0 the march bar, later bounces at most 5% of the entries off by more than
1e-4 and none by 2e-2).  Against the port's mega recorder (whose primary
rays the port computes itself, bitwise those of `spp_rays`): measured
equal, so held equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_banked_t_close, np_tree
from _torch_paths import scene_pair

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.rng import RNGStream as JRNG
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.kernels import record as jrecord
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import eye_vec, primary_rays
from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.kernels import record as trecord
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.integrator import spp_rays
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_W, _H = 32, 16
_ORIGIN = (4, 8)
# (scene, direct_light, config extras)
_CASES = {
    "csg_nee": ("csg_demo", True, {}),
    "all_materials_nee_rr": ("all_materials", True,
                             dict(rr_start_bounce=1, rr_min_prob=0.05)),
    "csg_nee_exact_normal": ("csg_demo", True, dict(normal_taps=0)),
}


def _cfg(extra):
    return dict(width=64, height=32, max_steps=96, max_bounces=3,
                max_dist=100.0, **extra)


def _planes(cfg):
    """eye, d0 (3 planes each), px, py, sample as numpy (H, W) arrays."""
    corners = JCamera(aspect=2.0).corner_rays_flat()
    rows, cols = np.mgrid[0:_H, 0:_W].astype(np.int32)
    px, py = cols + _ORIGIN[0], rows + _ORIGIN[1]
    sample = np.random.RandomState(3).randint(0, 7, (_H, _W)).astype(
        np.uint32)
    rng = JRNG(cfg.seed, jnp.asarray(px), jnp.asarray(py),
               jnp.asarray(sample), jnp.uint32(1 << 20))
    d = primary_rays(corners, jnp.asarray(px), jnp.asarray(py), cfg.width,
                     cfg.height, rng)
    e = eye_vec(corners)
    eye = [np.broadcast_to(np.asarray(c, np.float32), (_H, _W)).copy()
           for c in e]
    return eye, [np.array(c) for c in d], px, py, sample


@pytest.mark.parametrize("case", list(_CASES))
def test_wavefront_banks_match_jax(case):
    """Measured: every decision equal.  t: on csg_demo bounce 0 within
    1.9e-6 and 0.7% of the later entries off by more than 1e-4 (max
    6.2e-4); on the all-materials scene one march step (5.0e-4) on a
    bounce-0 lane and 0.2% of the later entries off (max 7.6e-4)."""
    name, nee, extra = _CASES[case]
    js, ts = scene_pair(name)
    jp = js.init_params()
    jcfg = JCfg(**_cfg(extra))
    eye, d, px, py, sample = _planes(jcfg)
    want = jrecord.trace_record_fused(
        js, jp, jcfg, JVec3(*map(jnp.asarray, eye)),
        JVec3(*map(jnp.asarray, d)), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(sample), direct_light=nee, interpret=True,
        mode="wavefront")
    want = {k: np.asarray(v) for k, v in want.items()}
    t = torch.from_numpy
    got = trecord.trace_record_wavefront(
        ts, params_from_numpy(np_tree(jp), "cpu"), TCfg(**_cfg(extra)),
        TVec3(*map(t, eye)), TVec3(*map(t, d)), t(px), t(py),
        t(sample.astype(np.int64)), direct_light=nee)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want) == {"t", "mid", "hit", "sd"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    for k in ("mid", "hit", "sd"):
        np.testing.assert_array_equal(got[k], want[k])
    assert_banked_t_close(want["t"], got["t"], 1)
    assert got["hit"][1:].sum() > 0
    assert set(np.unique(got["sd"])) == {np.float32(0.0),
                                         np.float32(3.4e38)}


def test_wavefront_matches_mega_recorder():
    """The two recorders restate one trace (csg_demo with NEE, the case of
    tests/test_diff.py:449): the wavefront recorder over `spp_rays`'
    planes of one sample and the mega recorder (strict knobs on the CPU)
    over the same patch bank the same planes."""
    name, nee, extra = _CASES["csg_nee"]
    _, ts = scene_pair(name)
    tp = ts.init_params("cpu")
    cfg = TCfg(**_cfg(extra))
    corners = TCamera(aspect=2.0).corner_rays_flat("cpu")
    px, py, sample, eye, d = spp_rays(cfg, corners, _ORIGIN, (_H, _W), 5, 1)
    a = trecord.trace_record_wavefront(ts, tp, cfg, eye, d, px, py, sample,
                                       direct_light=nee)
    b = trecord.trace_record_fused(ts, tp, cfg, corners, _ORIGIN, (_H, _W),
                                   5, n_samples=1, direct_light=nee)
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_wavefront_refusals():
    """The mega entry point names the wavefront route; dispersion is a
    megakernel-schedule mode, as in the JAX package."""
    _, ts = scene_pair("glass_demo")
    tp = ts.init_params("cpu")
    corners = TCamera().corner_rays_flat("cpu")
    with pytest.raises(ValueError, match="trace_record_wavefront"):
        trecord.trace_record_fused(ts, tp, TCfg(width=8, height=8), corners,
                                   (0, 0), (8, 8), 0, mode="wavefront")
    cfg = TCfg(width=8, height=8, separate_channels=True)
    px, py, sample, eye, d = spp_rays(cfg, corners, (0, 0), (8, 8), 0, 1)
    with pytest.raises(NotImplementedError, match="dispersion"):
        trecord.trace_record_wavefront(ts, tp, cfg, eye, d, px, py, sample)
