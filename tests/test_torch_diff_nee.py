"""Port parity, the differentiable path with next-event estimation and
Russian roulette (see tests/test_torch_diff.py for the harness and the
bars without them).

NEE: the JAX package's own bar between its oracle and recorded paths,
loss to rtol 1e-5 and each leaf's gradient to atol 2e-2 * max|g|
(tests/test_diff.py:409-413: a grazing shadow ray can flip its verdict
under another compilation).  Against JAX on the floor-and-ball scene of
tests/test_diff.py's geometry-gradient test, whose radius gradient comes
only through NEE.  csg_demo with NEE takes over a minute to compile for
`jax.grad` on XLA:CPU, so there the port's recorded path is held to its
own oracle path with the same bar.  Russian roulette:
tests/test_torch_diff_rr.py.
"""
import numpy as np
import pytest

from _torch_grads import (assert_grads_close, case, jax_loss_grads,
                          port_loss_grads)
from _torch_parity import corners_to_torch

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import param_leaves

NEE_REL_ATOL = 2e-2


def _ball(b):
    """The floor, a ball of radius 1 and one light (tests/test_diff.py,
    TestPixelGradients.test_geometry_gradient_flows)."""
    sb = b.SceneBuilder()
    m_floor = sb.diffuse([0.8, 0.8, 0.8])
    m_ball = sb.diffuse([0.5, 0.5, 0.5])
    sb.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    sb.sphere(m_ball, [0, 1, 0], 1.0)
    sb.light([-4, 6, -3], 40.0, 0.5)
    sb.sky(0.1)
    return sb.build()


def test_nee_grads_match_jax():
    """64 x 32, 3 bounces, 2 samples, recorded on both sides.  Measured:
    loss relative difference 2e-8, leaves within 1e-6 * max|g|."""
    js, ts = _ball(jbuiltin), _ball(tbuiltin)
    cfg = dict(width=64, height=32, max_steps=96, max_bounces=3,
               max_dist=100.0)
    jp, jcfg, jc, tp, tcfg, tc = case(js, cfg, dict(aspect=2.0))
    want = jax_loss_grads(js, jp, jcfg, jc, "recorded", True, (32, 64), 2)
    got = port_loss_grads(ts, tp, tcfg, tc, "recorded", True, (32, 64), 2)
    assert_grads_close(want, got, NEE_REL_ATOL)
    radius = [i for i, leaf in enumerate(param_leaves(tp))
              if leaf is tp["objects"][1][1]][0]
    assert float(np.abs(got[1][radius]).max()) > 0.0


@pytest.mark.parametrize("nee", [False, True], ids=["no_nee", "nee"])
def test_exact_normal_grads_match_jax(nee):
    """`normal_taps=0`: under NEE the normal enters the cos term, so the
    radius gradient carries the normal's own derivative (the replay's
    second-order term: the reverse sweep keeps its graph, inside the
    remat region).  48 x 24, 2 bounces, 2 samples; the JAX side on its
    oracle march (jax.grad through its jax.vjp normal), the port on its
    oracle march without NEE and recorded with NEE, with remat.  Bars:
    1e-4 * max|g| per leaf, 2e-2 with NEE (the recorder's march against
    the oracle's moves a grazing path); the loss to 1e-4: without NEE
    the two images are bitwise equal, and the losses, float32 sums of the
    3456 squared values in two orders, differ by 1.27e-5 relative, at 6
    taps as at 0."""
    js, ts = _ball(jbuiltin), _ball(tbuiltin)
    cfg = dict(width=48, height=24, max_steps=96, max_bounces=2,
               max_dist=100.0, normal_taps=0)
    jp, jcfg, jc, tp, tcfg, tc = case(js, cfg, dict(aspect=2.0))
    want = jax_loss_grads(js, jp, jcfg, jc, "oracle", nee, (24, 48), 2)
    got = port_loss_grads(ts, tp, tcfg, tc, "recorded" if nee else "oracle",
                          nee, (24, 48), 2, remat=True)
    assert_grads_close(want, got, NEE_REL_ATOL if nee else 1e-4,
                       loss_rtol=1e-4)
    if nee:
        radius = [i for i, leaf in enumerate(param_leaves(tp))
                  if leaf is tp["objects"][1][1]][0]
        assert float(np.abs(got[1][radius]).max()) > 0.0


@pytest.mark.parametrize("impl", ["fused", "recorded"])
def test_csg_nee_matches_port_oracle(impl):
    """csg_demo with NEE, 32 x 16, 3 bounces, 2 samples: each march
    implementation against the port's oracle path."""
    ts = tbuiltin.csg_demo()
    cfg = TCfg(width=32, height=16, max_steps=96, max_bounces=3,
               max_dist=100.0)
    tp = ts.init_params("cpu")
    tc = corners_to_torch(JCamera(aspect=2.0).corner_rays_flat())
    want = port_loss_grads(ts, tp, cfg, tc, "oracle", True, (16, 32), 2)
    got = port_loss_grads(ts, tp, cfg, tc, impl, True, (16, 32), 2)
    assert_grads_close(want, got, NEE_REL_ATOL)
