"""Port parity, the per-ray march: `render.integrator.march` (the plain
version of the CUDA kernel `march_fused`) against the JAX package's
`march` and its Pallas kernel `march_fused` in interpret mode.

The same seeded ray planes go through both: rays from the camera toward
the scene, a quarter of them starting inside the ball and marching out
with dist_mult = -1, a per-lane t_max (the shadow-ray cap) on a plane of
its own, and inactive lanes.  Decisions (hit, material) must match
exactly.  t must match to 1e-6 relative (XLA:CPU's sqrt is 1 ulp off the
correctly rounded one, ROADMAP Queue 3, and a march carries that to
2 ulp of t), except on fewer than 5e-3 of the lanes (the JAX package's
own bar between two of its recorders, tests/test_diff.py), where the ulp
moves a grazing ray's hit to the neighbouring march step, by less than
1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_t_close, np_tree

from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.kernels.march import march_fused as jmarch_fused
from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_SHAPE = (24, 32)


def _rays(seed=5):
    """(o, d, dist_mult, active, t_max) numpy planes: camera rays, a
    quarter of them inside the ball (centre (0, 1, 0), radius 1) with
    dist_mult -1, one lane in eight inactive, t_max in [2, 12]."""
    rng = np.random.RandomState(seed)
    h, w = _SHAPE
    o = np.broadcast_to(np.float32([0.0, 4.0, -6.0]), (h, w, 3)).copy()
    fwd = np.float32([0.0, -3.0, 6.0]) / np.float32(np.sqrt(45.0))
    d = fwd + rng.uniform(-0.45, 0.45, (h, w, 3)).astype(np.float32)
    inside = rng.uniform(size=(h, w)) < 0.25
    o[inside] = (np.float32([0.0, 1.0, 0.0])
                 + rng.uniform(-0.4, 0.4, (int(inside.sum()), 3)))
    d[inside] = rng.normal(size=(int(inside.sum()), 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dist_mult = np.where(inside, -1.0, 1.0).astype(np.float32)
    active = rng.uniform(size=(h, w)) >= 0.125
    t_max = rng.uniform(2.0, 12.0, (h, w)).astype(np.float32)
    return o.astype(np.float32), d, dist_mult, active, t_max


def _pair(relax, t_max_on):
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
                                        t_max=jt))(jp)
    got = tint.march(ts, tp, TCfg(**kw), to, td, torch.from_numpy(dm),
                     torch.from_numpy(act), t_max=tt)
    return (js, jp, JCfg(**kw), jo, jd, dm, act, jt), want, got


def _assert_same(want, got):
    wt, wm, wh = (np.asarray(a) for a in want)
    gt, gm, gh = (a.numpy() for a in got)
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_array_equal(gm, wm)
    assert_t_close(wt, gt)


@pytest.mark.parametrize("t_max_on", [False, True], ids=["max_dist", "t_max"])
@pytest.mark.parametrize("relax", [0.0, 1.9], ids=["classic", "relaxed"])
def test_march_matches_jax(relax, t_max_on):
    """Measured: decisions exact; t off by more than 1e-6 relative on 1
    lane of 768 (classic, 5.0e-4: one step) and on none otherwise."""
    _, want, got = _pair(relax, t_max_on)
    _assert_same(want, got)
    t, mid, hit = got
    o, d, dm, act, tmax = _rays()
    assert hit.dtype == torch.bool and mid.dtype == torch.int32
    assert not bool(hit[torch.from_numpy(~act)].any())   # inactive: misses
    assert bool(hit[torch.from_numpy(dm < 0)].any())      # marched out
    cap = torch.from_numpy(tmax) if t_max_on else 100.0
    miss = ~hit
    assert bool((t[miss] == (cap[miss] if t_max_on else cap)).all())
    assert bool((mid[miss] == -1).all())


@pytest.mark.parametrize("relax", [0.0, 1.9], ids=["classic", "relaxed"])
def test_march_matches_jax_pallas_interpret(relax):
    """The JAX Pallas kernel `march_fused` (interpret mode) is bitwise the
    JAX `march`; the port's plain version holds to it as to `march`, and
    the port's `march_fused` on CPU tensors is that plain version (no
    launch)."""
    (js, jp, cfg, jo, jd, dm, act, jt), _, got = _pair(relax, True)
    t, mid, hit = jmarch_fused(js, jp, cfg, jo, jd, jnp.asarray(dm),
                               jnp.asarray(act), block=(8, 32),
                               interpret=True, t_max=jt)
    _assert_same((t, mid, hit), got)
    ts = tbuiltin.sphere_on_floor()
    o, d, _, _, tmax = _rays()
    launches = tmarch.MARCH_FUSED.launches
    fused = tmarch.march_fused(
        ts, ts.init_params("cpu"), TCfg(width=32, height=24, max_steps=160,
                                        max_dist=100.0, relax_omega=relax),
        TVec3(*(torch.from_numpy(o[..., k].copy()) for k in range(3))),
        TVec3(*(torch.from_numpy(d[..., k].copy()) for k in range(3))),
        torch.from_numpy(dm), torch.from_numpy(act),
        t_max=torch.from_numpy(tmax))
    assert tmarch.MARCH_FUSED.launches == launches
    for a, b in zip(fused, got):
        assert torch.equal(a, b)
