"""Port parity, the work counters: `trace_spectral(profile=True)`,
`trace_mega_spectral(with_occupancy=True)` and their readers in
`utils/metrics.py`, against the JAX package's on the same inputs.

The counters are those of the strict oracle and the counter-based RNG, so
they agree but for the rare lane whose march a 1-ulp difference of
XLA:CPU's sqrt / sin / cos moves: the bar is equal counts on at least 99%
of the lanes and sums within 0.5% (measured: every lane equal).  The
histogram of `instrumented_sample` is an exact bincount over
`jnp.histogram`'s float32 edges: equal bucket for bucket on the same
steps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import corners_to_torch

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.rng import RNGStream as JRNG
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import (eye_vec as jeye,
                                                pixel_grid as jgrid,
                                                primary_rays as jrays)
from raymarchrenderer_tpu.utils import metrics as jmetrics
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.utils import metrics as tmetrics

_KW = dict(width=32, height=24, max_steps=128, max_bounces=4,
           max_dist=100.0, relax_omega=2.0, normal_taps=4)
# a production-like schedule at a unroll small enough to compile quickly
_SCHED = dict(march_unroll=8, lazy_miss=True, regen_cadence=4)


def _lanes_agree(want, got):
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (want == got).mean() >= 0.99, (want != got).sum()
    assert abs(int(got.sum()) - int(want.sum())) <= 5e-3 * int(want.sum())


def _demo():
    js, jp, jm = jspec.spectral_demo()
    ts, tp, tm = tspec.spectral_demo("cpu")
    return (js, jp, jm), (ts, tp, tm)


def test_trace_spectral_profile_counters_match_jax():
    """Per-lane segments, march map evaluations and hits of one sample,
    and their sums equal the `work` counts of the same call."""
    (js, jp, jm), (ts, tp, tm) = _demo()
    corners = JCamera(aspect=32 / 24).corner_rays_flat()
    px, py = jgrid(32, 24)

    def jax_run(p):
        rng = JRNG(0, px, py, jnp.uint32(1), jnp.uint32(1 << 20))
        d = jrays(corners, px, py, 32, 24, rng)
        e = jeye(corners)
        eye = JVec3(*(jnp.broadcast_to(c, (24, 32)) for c in e))
        return jspec.trace_spectral(js, p, jm, JCfg(**_KW), eye, d, px, py,
                                    jnp.uint32(1), profile=True)

    want = jax.jit(jax_run)(jp)
    tc = corners_to_torch(corners)
    tx, ty = tgrid(32, 24, "cpu")
    d = tmetrics._primary_rays(TCfg(**_KW), tc, tx, ty, 1)
    work = {}
    got = tspec.trace_spectral(ts, tp, tm, TCfg(**_KW),
                               tmetrics._eye_planes(tc, (24, 32)), d, tx, ty,
                               1, profile=True, work=work)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for w, g in zip(want[2:], got[2:]):
        _lanes_agree(w, g)
    assert int(got[3].sum()) == int(work["march"])
    assert int(got[4].sum()) == int(work["shade"])
    assert int(got[2].sum()) >= 32 * 24        # every lane marched once


def test_occupancy_counters_match_jax():
    """Per-lane m_cnt / tot_cnt of one tile under a lazy-miss schedule,
    and the image unchanged by the counters."""
    (js, jp, jm), (ts, tp, tm) = _demo()
    corners = JCamera(aspect=32 / 24).corner_rays_flat()
    px, py = jgrid(32, 24)
    want = jax.jit(lambda p: jmega.trace_mega_spectral(
        js, p, jm, JCfg(**_KW), corners, px, py, jnp.uint32(1), n_samples=2,
        with_occupancy=True, **_SCHED))(jp)
    tx, ty = tgrid(32, 24, "cpu")
    tc = corners_to_torch(corners)
    acc, m, t = tmega.trace_mega_spectral(
        ts, tp, tm, TCfg(**_KW), tc, tx, ty, 1, n_samples=2,
        with_occupancy=True, **_SCHED)
    _lanes_agree(want[1], m)
    _lanes_agree(want[2], t)
    assert bool((m <= t).all()) and int(m.sum()) > 0
    plain = tmega.trace_mega_spectral(ts, tp, tm, TCfg(**_KW), tc, tx, ty, 1,
                                      n_samples=2, **_SCHED)
    for a, b in zip(acc, plain):
        assert torch.equal(a, b)


def test_occupancy_refuses_record_banks():
    (_, _, _), (ts, tp, tm) = _demo()
    tx, ty = tgrid(4, 4, "cpu")
    tc = corners_to_torch(JCamera().corner_rays_flat())
    with pytest.raises(ValueError, match="render-only"):
        tmega.trace_mega_spectral(ts, tp, tm, TCfg(**_KW), tc, tx, ty, 0,
                                  record_banks=True, with_occupancy=True)


def test_spectral_path_profile_matches_jax():
    (js, jp, jm), (ts, tp, tm) = _demo()
    corners = JCamera(aspect=32 / 24).corner_rays_flat()
    want = jmetrics.spectral_path_profile(js, jp, jm, JCfg(**_KW), corners,
                                          jnp.uint32(1), n_samples=2)
    got = tmetrics.spectral_path_profile(ts, tp, tm, TCfg(**_KW),
                                         corners_to_torch(corners), 1,
                                         n_samples=2)
    assert set(got) == set(want) and got["profile_samples"] == 2
    for k in want:
        assert abs(got[k] - want[k]) <= 5e-3 * abs(want[k]), (k, got, want)
    assert got["map_evals_per_sample"] == pytest.approx(
        got["march_map_evals_per_sample"] + 4 * got["hits_per_sample"],
        abs=2e-4)


def test_mega_occupancy_profile_matches_jax():
    """Two (8, 16) tiles of a 32 x 24 frame, one call per tile as JAX's
    loop."""
    (js, jp, jm), (ts, tp, tm) = _demo()
    corners = JCamera(aspect=32 / 24).corner_rays_flat()
    kw = dict(n_samples=2, tiles=2, bh=8, bw=16, **_SCHED)
    want = jmetrics.mega_occupancy_profile(js, jp, jm, JCfg(**_KW), corners,
                                           jnp.uint32(1), **kw)
    got = tmetrics.mega_occupancy_profile(ts, tp, tm, TCfg(**_KW),
                                          corners_to_torch(corners), 1, **kw)
    assert got["occupancy_tiles"] == want["occupancy_tiles"] == 2
    assert got["occupancy_spp"] == 2
    assert abs(got["march_occupancy"] - want["march_occupancy"]) <= 2e-3
    assert 0.0 < got["march_occupancy"] < 1.0


def test_steps_histogram_is_jnp_histogram():
    """An exact bincount over jnp.histogram's float32 edges, the closed
    last bucket and the values outside included."""
    rs = np.random.RandomState(3)
    steps = rs.randint(0, 200, size=(40, 50)).astype(np.int32)
    steps[0, :5] = (0, 192, 193, 12, 24)
    edges = np.linspace(0, 192, 17)
    want = np.asarray(jnp.histogram(jnp.asarray(steps, jnp.float32),
                                    bins=jnp.asarray(edges, jnp.float32))[0])
    got = tmetrics.steps_histogram(torch.from_numpy(steps), edges)
    np.testing.assert_array_equal(got, want)


def test_instrumented_sample_matches_jax():
    kw = dict(width=24, height=16, max_steps=96, max_bounces=2,
              max_dist=100.0)
    from raymarchrenderer_tpu.scene import builtin as jbuiltin
    jscene = jbuiltin.sphere_on_floor()
    tscene = tbuiltin.sphere_on_floor()
    corners = JCamera(aspect=1.5).corner_rays_flat()
    jcolor, jstats = jmetrics.instrumented_sample(
        jscene, jscene.init_params(), JCfg(**kw), corners, jnp.uint32(2),
        n_buckets=8)
    tcolor, tstats = tmetrics.instrumented_sample(
        tscene, tscene.init_params("cpu"), TCfg(**kw),
        corners_to_torch(corners), 2, n_buckets=8)
    assert tcolor.shape == (16, 24, 3)
    np.testing.assert_allclose(tcolor.numpy(), np.asarray(jcolor),
                               atol=1e-5)
    assert tstats.primary_hit_rate == pytest.approx(jstats.primary_hit_rate)
    assert tstats.mean_primary_steps == pytest.approx(
        jstats.mean_primary_steps, rel=5e-3)
    np.testing.assert_array_equal(tstats.steps_bucket_edges,
                                  jstats.steps_bucket_edges)
    assert np.abs(tstats.steps_histogram
                  - jstats.steps_histogram).sum() <= 0.01 * 24 * 16
    assert set(tstats.to_dict()) == set(jstats.to_dict())


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    log = tmetrics.MetricsLogger(str(path))
    stats = tmetrics.RenderStats(pixels=4, primary_hit_rate=0.5,
                                 mean_primary_steps=3.0,
                                 steps_histogram=np.zeros(2, np.int32),
                                 steps_bucket_edges=np.linspace(0, 4, 3),
                                 wall_s=2.0)
    log.log("render_start", width=2)
    log.log_stats("sample", stats, s=0)
    log.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["event"] for x in lines] == ["render_start", "sample"]
    assert lines[1]["rays_per_s"] == 2.0 and lines[1]["s"] == 0
