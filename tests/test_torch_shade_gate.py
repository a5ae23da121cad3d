"""Port parity, the shade gate (`shade_gate > 0`) of the megakernel
schedules and `trace_mega`.

At a gate g > 0 a body runs its shade pass only when the batch holds
parked lanes and n_park * g >= n_march (float32); the parked lanes wait
otherwise.  A skipped pass only delays the parked lanes' own transitions,
each segment starts at a pass boundary and counts its own steps, and every
draw is keyed on (pixel, sample, bounce), so the port's plain versions
give gate 0's bytes at every gate, under the strict schedule and under
`lazy_miss` with a cadence, NEE, dispersion, roulette and the deferred sky
(the JAX package's own contract, tests/test_mega.py, covers the strict
schedule).  Against the JAX package at a gate above 0: the bars of
`_torch_parity.py` (fewer than 1e-3 of the values off by more than 1e-5;
the NEE bar with NEE), as at gate 0.  `trace_mega`, one sample through
the RGB schedule at gate 1, is bitwise the port's `trace_rgb` (through
`render_sample`), as the JAX package's is its own.  The wrappers' CPU
routes take the gate to the plain versions.  Every frame is 24 x 16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_env import env_scenes
from _torch_parity import (MAX_FRAC_OFF, assert_nee_close, corners_to_torch,
                           frac_off, np_tree)

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import mega as jmega
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import pixel_grid as jgrid
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid as tgrid
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import params_from_numpy

W, H = 24, 16
GATES = (0.25, 1.0, 32.0, 1e9)
_CORNELL_CAM = dict(eye=(0, 2, 5.4), direction=(0, 0, -1))
_STRICT = dict(relax_omega=0.0, normal_taps=6), dict(
    lazy_miss=False, march_unroll=4, regen_cadence=0)
# the production knobs, scaled to the frame: 8 steps a body, a cheap
# pass every 4, the lazy miss test
_LAZY = dict(relax_omega=2.0, normal_taps=4), dict(
    lazy_miss=True, march_unroll=8, regen_cadence=4)

# name: (scene, transport, config knobs and extras, direct_light, camera)
_CASES = {
    "sphere_on_floor-strict": ("sphere_on_floor", "rgb", _STRICT, {}, False,
                               None),
    "csg_nee-lazy_cadence": ("csg_demo", "rgb", _LAZY, {}, True, None),
    "cornell-dispersion-rr": ("cornell", "rgb", _LAZY, dict(
        separate_channels=True, rr_start_bounce=1), False, _CORNELL_CAM),
    "deferred-nee": ("env", "defer", _LAZY, {}, True, None),
    "spectral-lazy_cadence": ("spectral_demo", "spectral", _LAZY, {}, False,
                              None),
}


def _cfg(knobs, extra):
    return dict(width=W, height=H, max_steps=64, max_bounces=4,
                max_dist=100.0, **knobs[0], **extra)


def _port_scene(name):
    """(scene, params, band table or None) of the port, on the CPU."""
    if name == "spectral_demo":
        return tspec.spectral_demo("cpu")
    if name == "env":
        scene = env_scenes("nee", np.random.RandomState(7).uniform(
            0.0, 2.0, (8, 16, 3)).astype(np.float32))[1]
    else:
        scene = getattr(tbuiltin, name)()
    return scene, scene.init_params("cpu"), None


def _port_trace(case, gate):
    """The port's plain version of `case` at `gate`: a list of tensors
    (the sum, and the deferred sky's four banks)."""
    name, transport, knobs, extra, nee, cam = _CASES[case]
    scene, params, mats = _port_scene(name)
    cfg = TCfg(**_cfg(knobs, extra))
    corners = TCamera(aspect=W / H, **(cam or {})).corner_rays_flat("cpu")
    px, py = tgrid(W, H, "cpu")
    if transport == "spectral":
        return [tmega.trace_mega_spectral(
            scene, params, mats, cfg, corners, px, py, 1, n_samples=2,
            shade_gate=gate, **knobs[1]).stack(-1)]
    out = tmega.trace_mega_paths(
        scene, params, cfg, corners, px, py, 1, n_samples=2,
        shade_gate=gate, dispersion=cfg.separate_channels, direct_light=nee,
        defer_sky=transport == "defer", **knobs[1])
    if transport == "defer":
        return [out[0].stack(-1), *out[1]]
    return [out.stack(-1)]


@functools.lru_cache(maxsize=None)
def _gate_0(case):
    return _port_trace(case, 0.0)


@pytest.mark.parametrize("gate", GATES, ids=lambda g: f"gate{g:g}")
@pytest.mark.parametrize("case", list(_CASES))
def test_plain_gate_gives_gate_0_bytes(case, gate):
    """The port's plain version at `gate`, byte for byte against gate 0
    (the sum, and the deferred sky's thr and packed (u, v) banks)."""
    want = _gate_0(case)
    got = _port_trace(case, gate)
    assert float(want[0].abs().sum()) > 0.0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gate_changes_the_schedule_not_the_work():
    """The gate moves when passes run, so the bodies each lane runs
    (`lane_bodies`) change with it, while the map evaluations (march
    steps of live lanes, shaded hits) stay: the counters' callers state
    their gate."""
    scene, params, _ = _port_scene("sphere_on_floor")
    cfg = TCfg(**_cfg(_LAZY, {}))
    corners = TCamera(aspect=W / H).corner_rays_flat("cpu")
    px, py = tgrid(W, H, "cpu")
    works = []
    for gate in (0.0, 1.0):
        work = {}
        tmega.trace_mega_paths(scene, params, cfg, corners, px, py, 1,
                               n_samples=2, shade_gate=gate, work=work,
                               **_LAZY[1])
        works.append(work)
    assert int(works[0]["march"]) == int(works[1]["march"])
    assert int(works[0]["shade"]) == int(works[1]["shade"])
    assert int(works[1]["lane_bodies"].sum()) > int(
        works[0]["lane_bodies"].sum())


def test_nan_gate_is_refused():
    """A NaN gate would never let a pass run: every entry refuses it."""
    scene, params, _ = _port_scene("sphere_on_floor")
    cfg = TCfg(**_cfg(_STRICT, {}))
    corners = TCamera(aspect=W / H).corner_rays_flat("cpu")
    px, py = tgrid(W, H, "cpu")
    nan = float("nan")
    with pytest.raises(ValueError, match="NaN"):
        tmega.trace_mega_paths(scene, params, cfg, corners, px, py, 0,
                               shade_gate=nan)
    with pytest.raises(ValueError, match="NaN"):
        tmarch.render_fused(scene, params, cfg, corners, 0, shade_gate=nan)
    s, p, m = tspec.spectral_demo("cpu")
    with pytest.raises(ValueError, match="NaN"):
        tmarch.render_fused_spectral(s, p, m, cfg, corners, 0,
                                     shade_gate=nan)


# ---- against the JAX package at a gate above 0 ------------------------------

def _jax_scene(name):
    if name == "spectral_demo":
        return jspec.spectral_demo()
    if name == "env":
        scene = env_scenes("nee", np.random.RandomState(7).uniform(
            0.0, 2.0, (8, 16, 3)).astype(np.float32))[0]
    else:
        scene = getattr(jbuiltin, name)()
    return scene, scene.init_params(), None


def _jax_trace(case, gate):
    """The JAX package's schedule of `case` at `gate`, run as plain jnp
    (one jit): a list of numpy arrays as `_port_trace` returns."""
    name, transport, knobs, extra, nee, cam = _CASES[case]
    scene, params, mats = _jax_scene(name)
    cfg = JCfg(**_cfg(knobs, extra))
    corners = JCamera(aspect=W / H, **(cam or {})).corner_rays_flat()
    px, py = jgrid(W, H)
    if transport == "spectral":
        return [np.asarray(jax.jit(lambda p: jmega.trace_mega_spectral(
            scene, p, mats, cfg, corners, px, py, jnp.uint32(1),
            n_samples=2, shade_gate=gate, **knobs[1]).stack(-1))(params))]
    ch = JVec3.full((H, W), 1.0, 1.0, 1.0)
    out = jax.jit(lambda p: jmega.trace_mega_paths(
        scene, p, cfg, corners, px, py, jnp.uint32(1), ch, n_samples=2,
        shade_gate=gate, dispersion=cfg.separate_channels,
        direct_light=nee, defer_sky=transport == "defer",
        **knobs[1]))(params)
    if transport != "defer":
        return [np.asarray(out.stack(-1))]
    c, rec = out
    k = len(rec) // 4
    return [np.asarray(c.stack(-1))] + [
        np.stack([np.asarray(r) for r in rec[j * k:(j + 1) * k]])
        for j in range(4)]


@pytest.mark.parametrize("case,gate", [
    ("sphere_on_floor-strict", 1.0),
    ("csg_nee-lazy_cadence", 32.0),
    ("deferred-nee", 1.0),
    ("spectral-lazy_cadence", 1.0),
])
def test_gated_schedule_matches_jax(case, gate):
    """The port's plain version against the JAX package's at the same
    gate above 0: the kernel bar without NEE, the NEE bar with it; the
    deferred sky's thr banks at the kernel bar and its packed (u, v)
    equal on all but 5% of the live slots, at most 4 bins apart (as
    test_torch_env_render.py holds them at gate 0)."""
    nee = _CASES[case][4]
    want = _jax_trace(case, gate)
    got = [t.numpy() for t in _port_trace(case, gate)]
    assert np.isfinite(got[0]).all() and got[0].mean() > 0.0
    if nee:
        assert_nee_close(want[0], got[0])
    else:
        assert frac_off(want[0], got[0]) < MAX_FRAC_OFF
    if len(want) == 1:
        return
    for w, g in zip(want[1:4], got[1:4]):
        assert frac_off(w, g) < MAX_FRAC_OFF
    live = want[1] + want[2] + want[3] > 0
    assert live.mean() > 0.1
    du = np.abs((want[4] >> 16) - (got[4] >> 16))
    dv = np.abs((want[4] & 0xFFFF) - (got[4] & 0xFFFF))
    assert float(((du > 0) | (dv > 0))[live].mean()) < 5e-2
    assert max(int(du[live].max()), int(dv[live].max())) <= 4


# ---- trace_mega -------------------------------------------------------------

_MEGA_CFG = dict(width=W, height=H, max_steps=192, max_bounces=6,
                 max_dist=100.0)


@pytest.mark.parametrize("name,cam", [("sphere_on_floor", None),
                                      ("cornell", _CORNELL_CAM)])
def test_trace_mega_matches_jax_and_trace_rgb(name, cam):
    """`trace_mega` (one sample, gate 1) against the JAX package's
    `trace_mega` (the kernel bar; measured 0 values off) and, bitwise,
    against the port's `trace_rgb` on the sample's primary rays
    (`render_sample`)."""
    js = getattr(jbuiltin, name)()
    jp = js.init_params()
    corners = JCamera(aspect=W / H, **(cam or {})).corner_rays_flat()
    px, py = jgrid(W, H)
    ch = JVec3.full((H, W), 1.0, 1.0, 1.0)
    want = np.asarray(jax.jit(lambda p: jmega.trace_mega(
        js, p, JCfg(**_MEGA_CFG), corners, px, py, jnp.uint32(3),
        ch).stack(-1))(jp))
    ts = getattr(tbuiltin, name)()
    tp = params_from_numpy(np_tree(jp), "cpu")
    tc = corners_to_torch(corners)
    cfg = TCfg(**_MEGA_CFG)
    tx, ty = tgrid(W, H, "cpu")
    got = tmega.trace_mega(ts, tp, cfg, tc, tx, ty, 3).stack(-1)
    assert float(got.mean()) > 0.0
    assert frac_off(want, got.numpy()) < MAX_FRAC_OFF
    oracle = tint.render_sample(ts, tp, cfg, tc, 3).stack(-1)
    assert torch.equal(got, oracle)


# ---- the wrappers' CPU routes -----------------------------------------------

@pytest.mark.parametrize("route", ["render_fused_patch", "render_fused",
                                   "render_fused_spectral", "env"])
def test_wrapper_cpu_route_takes_the_gate(route):
    """The wrappers pass `shade_gate` to the plain versions on the CPU:
    the same bytes as their gate-0 calls, and the plain version at that
    gate called (the schedule's `lane_bodies` moves with the gate)."""
    calls = []
    spy_of = {"render_fused_spectral": "trace_mega_spectral"}
    name = spy_of.get(route, "trace_mega_paths")
    orig = getattr(tmarch, name)

    def spy(*a, **kw):
        calls.append(kw["shade_gate"])
        return orig(*a, **kw)

    cfg = TCfg(**_cfg(_LAZY, {}))
    corners = TCamera(aspect=W / H).corner_rays_flat("cpu")
    knobs = _LAZY[1]
    if route == "render_fused_spectral":
        s, p, m = tspec.spectral_demo("cpu")

        def run(g):
            return tmarch.render_fused_spectral(
                s, p, m, cfg, corners, 1, n_samples=2, origin_xy=(3, 2),
                patch_shape=(8, 12), shade_gate=g, **knobs)
    else:
        scene, params, _ = _port_scene(
            "env" if route == "env" else "csg_demo")
        if route == "render_fused":
            def run(g):
                return tmarch.render_fused(scene, params, cfg, corners, 1,
                                           n_samples=2, direct_light=True,
                                           shade_gate=g, **knobs)
        else:
            def run(g):
                return tmarch.render_fused_patch(
                    scene, params, cfg, corners, (3, 2), (8, 12), 1,
                    n_samples=2, direct_light=True, shade_gate=g, **knobs)
    setattr(tmarch, name, spy)
    try:
        ref = run(0.0)
        got = run(1.0)
    finally:
        setattr(tmarch, name, orig)
    assert calls == [0.0, 1.0]
    assert float(ref.abs().sum()) > 0.0 and torch.equal(got, ref)
