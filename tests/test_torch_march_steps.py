"""Port parity, the march's per-lane step counts: `render.integrator.march(
..., with_steps=True)` against the JAX package's `march(...,
with_steps=True)`, classic and relaxed.

The counts are the map evaluations each lane makes (the steps it is
live), the reading behind the lane-occupancy figures of the march kernels
(`chip_smoke.py`).  The same seeded planes as tests/test_torch_march.py go
through both: camera rays, a quarter of them inside the ball with
dist_mult -1, an eighth inactive, and the default or a per-lane t_max.
Bar: the counts are equal on every lane but those where XLA:CPU's
one-ulp sqrt moves a grazing hit to the neighbouring march step (the
lanes `assert_t_close` allows, fewer than 5e-3 of them), and there by
one step.  Measured: equal on all 768 lanes in every case but classic
with the default t_max, where 1 lane (1.3e-3) is one step apart.
The counts sum to the "march" work total, and inactive lanes count 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import T_FRAC_OFF, np_tree
from test_torch_march import _rays

from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import params_from_numpy


def _steps(relax, t_max_on):
    """(JAX outputs, port outputs, the port's work dict, planes)."""
    kw = dict(width=32, height=24, max_steps=160, max_dist=100.0,
              relax_omega=relax)
    js, ts = jbuiltin.sphere_on_floor(), tbuiltin.sphere_on_floor()
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    o, d, dm, act, tmax = _rays()
    jo = JVec3(*(jnp.asarray(o[..., k]) for k in range(3)))
    jd = JVec3(*(jnp.asarray(d[..., k]) for k in range(3)))
    to = TVec3(*(torch.from_numpy(o[..., k].copy()) for k in range(3)))
    td = TVec3(*(torch.from_numpy(d[..., k].copy()) for k in range(3)))
    jt = jnp.asarray(tmax) if t_max_on else None
    tt = torch.from_numpy(tmax) if t_max_on else None
    want = jax.jit(lambda p: jint.march(js, p, JCfg(**kw), jo, jd,
                                        jnp.asarray(dm), jnp.asarray(act),
                                        with_steps=True, t_max=jt))(jp)
    work = {}
    got = tint.march(ts, tp, TCfg(**kw), to, td, torch.from_numpy(dm),
                     torch.from_numpy(act), t_max=tt, work=work,
                     with_steps=True)
    return want, got, work, act


@pytest.mark.parametrize("t_max_on", [False, True], ids=["max_dist", "t_max"])
@pytest.mark.parametrize("relax", [0.0, 1.9], ids=["classic", "relaxed"])
def test_march_steps_match_jax(relax, t_max_on):
    want, got, work, act = _steps(relax, t_max_on)
    assert len(got) == 4 and got[3].dtype == torch.int32
    ws, gs = np.asarray(want[3]), got[3].numpy()
    off = ws != gs
    # the lanes a one-ulp sqrt moves to the neighbouring step, by one step
    assert float(off.mean()) < T_FRAC_OFF, (int(off.sum()), off.size)
    assert int(np.abs(ws - gs).max()) <= 1
    assert int(gs.sum()) == int(work["march"])
    assert not bool(gs[~act].any())
    assert bool((gs[act] >= 1).all())


@pytest.mark.parametrize("relax", [0.0, 1.9], ids=["classic", "relaxed"])
def test_march_with_steps_keeps_the_three_outputs(relax):
    """The first three outputs are the plain march's, bit for bit."""
    o, d, dm, act, tmax = _rays()
    cfg = TCfg(width=32, height=24, max_steps=160, max_dist=100.0,
               relax_omega=relax)
    scene = tbuiltin.sphere_on_floor()
    params = scene.init_params("cpu")
    to = TVec3(*(torch.from_numpy(o[..., k].copy()) for k in range(3)))
    td = TVec3(*(torch.from_numpy(d[..., k].copy()) for k in range(3)))
    args = (scene, params, cfg, to, td, torch.from_numpy(dm),
            torch.from_numpy(act))
    plain = tint.march(*args, t_max=torch.from_numpy(tmax))
    counted = tint.march(*args, t_max=torch.from_numpy(tmax),
                         with_steps=True)
    assert len(plain) == 3
    for a, b in zip(plain, counted[:3]):
        assert torch.equal(a, b)


def test_work_gathers_the_lane_steps():
    """A `work` dict with a "lane_steps" list gains each march's per-lane
    counts (the occupancy readings of a whole render's plain run), the
    same as `with_steps` returns."""
    o, d, dm, act, tmax = _rays()
    cfg = TCfg(width=32, height=24, max_steps=160, max_dist=100.0,
               relax_omega=1.9)
    scene = tbuiltin.sphere_on_floor()
    params = scene.init_params("cpu")
    to = TVec3(*(torch.from_numpy(o[..., k].copy()) for k in range(3)))
    td = TVec3(*(torch.from_numpy(d[..., k].copy()) for k in range(3)))
    args = (scene, params, cfg, to, td, torch.from_numpy(dm),
            torch.from_numpy(act))
    work = {"lane_steps": []}
    tint.march(*args, work=work)
    tint.march(*args, t_max=torch.from_numpy(tmax), work=work)
    assert len(work["lane_steps"]) == 2
    assert torch.equal(work["lane_steps"][0],
                       tint.march(*args, with_steps=True)[3])
    assert int(sum(s.sum() for s in work["lane_steps"])) == int(work["march"])
