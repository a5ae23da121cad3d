"""Port parity, the differentiable path with Russian roulette: the
cornell box seen through its open side, recorded on both sides, against
`jax.grad` of the JAX package: loss to rtol 1e-5 and each leaf's gradient
to atol 1e-4 * max|g| (tests/test_torch_diff.py's bars without NEE).
"""
from _torch_grads import (assert_grads_close, case, jax_loss_grads,
                          port_loss_grads)

from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin


def test_rr_grads_match_jax():
    """cornell with Russian roulette from bounce 1, 32 x 16, 3 bounces,
    2 samples, recorded on both sides.  Measured: loss relative
    difference 0, leaves within 1e-6 * max|g|."""
    js, ts = jbuiltin.cornell(), tbuiltin.cornell()
    cfg = dict(width=32, height=16, max_steps=96, max_bounces=3,
               max_dist=100.0, rr_start_bounce=1, rr_min_prob=0.05)
    jp, jcfg, jc, tp, tcfg, tc = case(
        js, cfg, dict(eye=(0.0, 2.0, 6.0), direction=(0.0, 0.0, -1.0),
                          aspect=2.0))
    want = jax_loss_grads(js, jp, jcfg, jc, "recorded", False, (16, 32), 2)
    assert want[0] > 0.0
    got = port_loss_grads(ts, tp, tcfg, tc, "recorded", False, (16, 32), 2)
    assert_grads_close(want, got, 1e-4)
