"""Port parity, elastic recovery (`parallel/recovery.py`): the six cases
of tests/test_recovery.py on the port, and the port's `oracle_shard_fn`
against the JAX package's.

The estimator's algebra: sample sums are associative and each shard is
keyed on absolute sample indices, so a retried shard is bit for bit the
same, and a dropped shard leaves the exact mean over the samples that
arrived.  Bars: a shard's raw sums against the JAX package's, its image
bar (fewer than 1e-3 of the values off by more than 1e-5; measured 0);
the elastic mean against the straight progressive render, atol 1e-6 (a
sum divided once against a running mean; the JAX package's bar).
"""
import numpy as np
import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, corners_to_torch, frac_off

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.parallel import recovery as jrecovery
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.parallel.recovery import (ElasticResult,
                                                          fused_shard_fn,
                                                          oracle_shard_fn,
                                                          render_elastic)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import render
from raymarchrenderer_tpu_torch.scene import builtin

# a step budget the megakernel's 32-step passes divide (the JAX package's
# rule for its knobs), so the fused shards' schedule meets the oracle's
_CFG = dict(width=16, height=16, max_steps=128, max_bounces=2,
            max_dist=100.0)


@pytest.fixture(scope="module")
def setup():
    scene = builtin.sphere_on_floor()
    corners = JCamera(aspect=1.0).corner_rays_flat()
    return (scene, scene.init_params("cpu"), RenderConfig(**_CFG),
            corners_to_torch(corners), corners)


def test_no_failure_matches_straight_render(setup):
    scene, params, cfg, corners, _ = setup
    run = oracle_shard_fn(scene, params, cfg, corners)
    res = render_elastic(run, cfg.height, cfg.width, spp=8, shard_spp=4)
    straight, n = render(scene, params, cfg, corners, spp=8)
    assert res.spp_achieved == 8 and not res.degraded
    assert res.image.dtype == np.float32
    np.testing.assert_allclose(res.image, straight.numpy(), atol=1e-6)


def test_transient_failure_retried_bitwise(setup):
    scene, params, cfg, corners, _ = setup
    inner = oracle_shard_fn(scene, params, cfg, corners)
    calls = {"n": 0}

    def flaky(sample0, n):
        calls["n"] += 1
        if sample0 == 4 and calls["n"] == 2:  # first attempt of shard 2
            raise RuntimeError("simulated card loss")
        return inner(sample0, n)

    res = render_elastic(flaky, cfg.height, cfg.width, spp=8, shard_spp=4,
                         max_retries=1)
    clean = render_elastic(inner, cfg.height, cfg.width, spp=8, shard_spp=4)
    assert res.spp_achieved == 8
    assert len(res.failures) == 1 and res.failures[0].sample0 == 4
    assert res.failures[0].error == "RuntimeError: simulated card loss"
    np.testing.assert_array_equal(res.image, clean.image)


def test_permanent_failure_drops_shard_unbiased(setup):
    scene, params, cfg, corners, _ = setup
    inner = oracle_shard_fn(scene, params, cfg, corners)
    events = []

    class Log:
        def log(self, event, **fields):
            events.append((event, fields.get("sample0")))

    def dead_shard(sample0, n):
        if sample0 == 4:
            raise RuntimeError("host gone")
        return inner(sample0, n)

    res = render_elastic(dead_shard, cfg.height, cfg.width, spp=12,
                         shard_spp=4, max_retries=2, logger=Log())
    assert res.degraded
    assert res.spp_achieved == 8
    assert res.dropped_shards == [4]
    assert len(res.failures) == 3  # 1 + 2 retries
    assert events == [("shard_failure", 4)] * 3 + [("shard_dropped", 4)]
    # exact mean over the samples that arrived (shards 0-3 and 8-11)
    manual = (inner(0, 4).numpy() + inner(8, 4).numpy()) / 8.0
    np.testing.assert_array_equal(res.image, manual.astype(np.float32))


def test_fused_shard_fn_matches_oracle_shards(setup):
    """The RGB kernel's plain version against the oracle, shard by shard:
    the JAX package's kernel bar (its interpret mode is bit for bit; the
    port's plain version runs the megakernel's schedule, measured 0
    values off)."""
    scene, params, cfg, corners, _ = setup
    run_o = oracle_shard_fn(scene, params, cfg, corners)
    run_f = fused_shard_fn(scene, params, cfg, corners)
    a = render_elastic(run_o, cfg.height, cfg.width, spp=4, shard_spp=2)
    b = render_elastic(run_f, cfg.height, cfg.width, spp=4, shard_spp=2)
    assert frac_off(a.image, b.image) < MAX_FRAC_OFF


def test_result_shape_and_fields():
    res = render_elastic(lambda s0, n: torch.zeros((4, 4, 3)), 4, 4, spp=4,
                         shard_spp=4)
    assert isinstance(res, ElasticResult)
    assert res.image.shape == (4, 4, 3)
    assert res.spp_requested == res.spp_achieved == 4
    assert res.failures == [] and res.dropped_shards == []


def test_oracle_shard_fn_matches_jax(setup):
    """The raw sums of samples 2 and 3 against the JAX package's, and the
    elastic image of 4 samples in shards of 2 against the JAX package's
    mean of the same shards (its oracle runs eagerly: few samples)."""
    scene, params, cfg, corners, jcorners = setup
    js = jbuiltin.sphere_on_floor()
    jrun = jrecovery.oracle_shard_fn(js, js.init_params(), JCfg(**_CFG),
                                     jcorners)
    run = oracle_shard_fn(scene, params, cfg, corners)
    jsums = {(0, 2): np.asarray(jrun(0, 2)), (2, 2): np.asarray(jrun(2, 2))}
    assert frac_off(jsums[2, 2], run(2, 2).numpy()) < MAX_FRAC_OFF
    want = jrecovery.render_elastic(lambda s0, n: jsums[s0, n], 16, 16,
                                    spp=4, shard_spp=2)
    got = render_elastic(run, 16, 16, spp=4, shard_spp=2)
    assert got.spp_achieved == want.spp_achieved == 4
    assert frac_off(want.image, got.image) < MAX_FRAC_OFF
