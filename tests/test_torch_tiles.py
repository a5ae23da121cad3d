"""Port parity, the tile driver: the spiral walk (Python and native), the
native work queue, and `ProgressiveRenderer` over the RGB patch kernel.

Orders are equal tile for tile to the JAX package's `spiral_tiles_py`.
The fused driver's tiles are byte-equal to one full-frame `render_fused`
launch (the kernel's plain version here: every per-lane value is keyed on
absolute pixels and sample indices, and the merge multiplies and divides
by a power of two), at the JAX package's own test configuration
(`tests/test_tiles_fused.py`).  The oracle driver is held to the JAX
package's oracle driver at the image bar of `_torch_parity` (fewer than
1e-3 of the values off by more than 1e-5; measured 0).
"""
import numpy as np
import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, corners_to_torch, frac_off

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.render import tiles as jtiles
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.kernels.march import render_fused
from raymarchrenderer_tpu_torch.render import scheduler_native
from raymarchrenderer_tpu_torch.render import tiles as ttiles
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin

_GRIDS = [(1, 1), (4, 4), (3, 5), (8, 2), (7, 7)]
# tests/test_tiles_fused.py's CFG
_CFG = dict(width=256, height=64, spp=2, max_steps=96, max_bounces=3,
            max_dist=100.0, grid_width=2, grid_height=2)


@pytest.mark.parametrize("gw, gh", _GRIDS)
def test_spiral_tiles_py_matches_jax(gw, gh):
    want = list(jtiles.spiral_tiles_py(gw, gh))
    assert list(ttiles.spiral_tiles_py(gw, gh)) == want
    assert sorted(want) == [(x, y) for x in range(gw) for y in range(gh)]


@pytest.mark.parametrize("gw, gh", _GRIDS)
def test_native_spiral_order_matches_jax(gw, gh):
    assert scheduler_native.available()
    want = list(jtiles.spiral_tiles_py(gw, gh))
    assert scheduler_native.spiral_order(gw, gh) == want
    assert list(ttiles.spiral_tiles(gw, gh)) == want


def test_native_scheduler_finite():
    units = list(scheduler_native.NativeScheduler(2, 2, 3))
    order = list(jtiles.spiral_tiles_py(2, 2))
    assert units == [(x, y, s) for (x, y) in order for s in range(3)]


def test_native_scheduler_endless_and_cancel():
    sched = scheduler_native.NativeScheduler(2, 2, 0)
    got = []
    for i, u in enumerate(sched):
        got.append(u)
        if i == 9:
            sched.cancel()
    order = list(jtiles.spiral_tiles_py(2, 2))
    want = [(x, y, p) for p in range(3) for (x, y) in order]
    assert len(got) >= 10 and got == want[:len(got)]


@pytest.mark.parametrize("args", [(0, 4, 1), (4, 0, 1), (2, 2, -1)])
def test_native_scheduler_bad_args(args):
    with pytest.raises(ValueError):
        scheduler_native.NativeScheduler(*args)


def _corners():
    return corners_to_torch(JCamera(aspect=4.0).corner_rays_flat())


def _nee_scene():
    b = tbuiltin.SceneBuilder()
    m = b.diffuse([0.7, 0.7, 0.7])
    b.sphere(m, [0, 1, 0], 1.0)
    b.box(m, [0, -0.05, 0], [8, 0.05, 8])
    b.light([3, 6, -3], 40.0, 0.5)
    return b.build()


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_fused_tiles_byte_equal_full_frame(nee):
    scene = _nee_scene() if nee else tbuiltin.sphere_on_floor()
    params = scene.init_params("cpu")
    cfg = TCfg(**_CFG)
    spp = 1 if nee else 2
    pr = ttiles.ProgressiveRenderer(scene, params, cfg, _corners(),
                                    impl="fused", direct_light=nee)
    seen = []
    tiled = pr.render_pass(spp=spp, callback=lambda x, y, a: seen.append(
        (x, y)))
    full = render_fused(scene, params, cfg, _corners(), 0, n_samples=spp,
                        direct_light=nee)
    assert seen == list(jtiles.spiral_tiles_py(2, 2))
    assert full.mean() > 0.0 and torch.equal(tiled, full)


def test_fused_endless_passes_are_the_running_mean_of_launches():
    scene = tbuiltin.sphere_on_floor()
    params = scene.init_params("cpu")
    cfg = TCfg(**_CFG)
    pr = ttiles.ProgressiveRenderer(scene, params, cfg, _corners(),
                                    impl="fused")
    got = pr.endless_passes(2)
    want = torch.zeros_like(got)
    for p in range(2):
        frame = render_fused(scene, params, cfg, _corners(), p, n_samples=1)
        want = (want * float(p) + frame * 1.0) / (p + 1.0)
    assert pr.pass_n == 2.0 and torch.equal(got, want)


def _count_calls(monkeypatch, module, name):
    """Replace `module.name` by a wrapper that logs the (origin, shape,
    first sample, samples) of each call and then makes it."""
    real, calls = getattr(module, name), []

    def counted(scene, params, cfg, corners, origin, shape, sample0, *a,
                **k):
        calls.append((tuple(origin), tuple(shape), int(sample0),
                      k.get("n_samples", 1)))
        return real(scene, params, cfg, corners, origin, shape, sample0,
                    *a, **k)
    monkeypatch.setattr(module, name, counted)
    return calls


_SMALL = dict(_CFG, width=64, height=32, max_steps=32, max_bounces=2)


def _renderer(impl):
    scene = tbuiltin.sphere_on_floor()
    return ttiles.ProgressiveRenderer(scene, scene.init_params("cpu"),
                                      TCfg(**_SMALL), _corners(), impl=impl)


def test_fused_endless_pass_is_one_launch_of_the_frame(monkeypatch):
    from raymarchrenderer_tpu_torch.kernels import march
    calls = _count_calls(monkeypatch, march, "render_fused_patch")
    pr = _renderer("fused")
    seen = []
    pr.endless_passes(2, callback=lambda p, a: seen.append(p))
    assert calls == [((0, 0), (32, 64), 0, 1), ((0, 0), (32, 64), 1, 1)]
    assert seen == [0, 1] and pr.pass_n == 2.0


def test_fused_finite_pass_is_one_launch_a_tile(monkeypatch):
    from raymarchrenderer_tpu_torch.kernels import march
    calls = _count_calls(monkeypatch, march, "render_fused_patch")
    _renderer("fused").render_pass(spp=2)
    assert calls == [((x * 32, y * 16), (16, 32), 0, 2)
                     for x, y in ttiles.spiral_tiles_py(2, 2)]


def test_oracle_endless_pass_walks_the_spiral(monkeypatch):
    calls = _count_calls(monkeypatch, ttiles, "render_patch")
    _renderer("oracle").endless_passes(2)
    order = list(ttiles.spiral_tiles_py(2, 2))
    assert calls == [((x * 32, y * 16), (16, 32), p, 1)
                     for p in range(2) for x, y in order]


def test_oracle_driver_matches_jax():
    """A finite pass of 2 samples and two endless passes, 64 x 32 on a
    2 x 2 grid, against the JAX package's oracle driver."""
    kw = dict(_CFG, width=64, height=32)
    jscene, tscene = jbuiltin.sphere_on_floor(), tbuiltin.sphere_on_floor()
    jc = JCamera(aspect=2.0).corner_rays_flat()
    jp, tp = jscene.init_params(), tscene.init_params("cpu")
    jpr = jtiles.ProgressiveRenderer(jscene, jp, JCfg(**kw), jc,
                                     impl="oracle")
    tpr = ttiles.ProgressiveRenderer(tscene, tp, TCfg(**kw),
                                     corners_to_torch(jc))
    assert tpr.impl == "oracle"             # "auto" on the CPU
    want = np.asarray(jpr.render_pass(spp=2))
    got = tpr.render_pass(spp=2).numpy()
    assert got.mean() > 0.0 and frac_off(want, got) < MAX_FRAC_OFF
    jpr = jtiles.ProgressiveRenderer(jscene, jp, JCfg(**kw), jc,
                                     impl="oracle")
    tpr = ttiles.ProgressiveRenderer(tscene, tp, TCfg(**kw),
                                     corners_to_torch(jc), impl="oracle")
    want = np.asarray(jpr.endless_passes(2))
    got = tpr.endless_passes(2).numpy()
    assert frac_off(want, got) < MAX_FRAC_OFF


def test_grid_that_does_not_divide_the_frame_raises():
    scene = tbuiltin.sphere_on_floor()
    cfg = TCfg(width=100, height=64, grid_width=3, grid_height=2)
    with pytest.raises(ValueError, match="divisible"):
        ttiles.ProgressiveRenderer(scene, scene.init_params("cpu"), cfg,
                                   _corners())
    with pytest.raises(ValueError, match="impl"):
        ttiles.ProgressiveRenderer(scene, scene.init_params("cpu"),
                                   TCfg(**_CFG), _corners(), impl="x")
    # the JAX package raises the same on the same grid
    with pytest.raises(ValueError):
        jscene = jbuiltin.sphere_on_floor()
        jtiles.ProgressiveRenderer(jscene, jscene.init_params(),
                                   JCfg(width=100, height=64, grid_width=3,
                                        grid_height=2),
                                   JCamera().corner_rays_flat())


def test_tile_launch_is_the_full_frame_patch():
    """`render_fused_patch_for_tiles` at a tile's origin equals the same
    pixels of the full-frame launch."""
    scene = tbuiltin.sphere_on_floor()
    params = scene.init_params("cpu")
    cfg = TCfg(**_CFG)
    tile = ttiles.render_fused_patch_for_tiles(scene, params, cfg, _corners(),
                                               (128, 32), (32, 128), 3, 2,
                                               False)
    full = render_fused(scene, params, cfg, _corners(), 3, n_samples=2)
    assert torch.equal(tile, full[32:64, 128:256])
