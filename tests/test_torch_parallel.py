"""Port parity, the (tile, spp) device layout (`parallel/sharding.py`):
`make_mesh` and `auto_shard` against the JAX package's, the sharded
renders against the port's one-device render and against the JAX
package's `render_sharded` / `render_sharded_spectral` on the same
layout (its 8 virtual CPU devices, tests/conftest.py), and the sharded
train steps against the port's one-position step and the JAX package's.

The port's layouts are virtual positions: one CPU device repeated, each
position rendered after the other.  Bars:

  * a layout with one sample slice per tile is byte-equal to the
    one-device render (each pixel's sample loop is the one launch's);
  * with an spp axis the merge re-associates the sum: the oracle within
    the JAX package's bar against its unsharded render, rtol 1e-5 / atol
    1e-6 (measured at most 2.4e-7 apart);
  * the RGB kernel's plain version (`impl="fused"`) with an spp axis is
    the megakernel's schedule: its lazy miss test runs at pass boundaries
    (32 steps), so a path that runs out of its step budget between two
    boundaries depends on the step its sample started at, which the
    sample slicing moves.  Bar: fewer than 1% of the values off by more
    than 1e-5, none by 1e-2 (measured: none at 16 rows; at 23 rows one
    pixel, 2.7e-3 of the values, by 1e-3 at most);
  * against the JAX package's sharded render: its image bar, fewer than
    1e-3 of the values off by more than 1e-5 (measured: the oracle within
    4.8e-7 everywhere), and the fused bar above where the JAX package's
    interpret mode (one step a pass) meets the port's schedule.

The train steps (recorded marches, lr 1): the port's gradient does not
depend on the layout (each leaf within 1e-5 * max|g| of the
one-position step's, measured 1.1e-7), and the JAX package's sharded
update is **tile * spp times** the true one (its loss function psums
inside the shard_map, so each device's gradient is global already, and
its psum over both axes multiplies it by the number of devices; ROADMAP
Queue 3): JAX's update divided by tile * spp is the port's within the
standing gradient bar, 1e-4 * max|g| per leaf (measured 3.0e-6, most of
it the float32 rounding of p - g).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MAX_FRAC_OFF, corners_to_torch, frac_off,
                           mats_to_torch, np_tree)

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.parallel import sharding as jsharding
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.parallel import sharding as tsharding
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import param_leaves, params_from_numpy

CPU8 = [torch.device("cpu")] * 8
# 128 march steps: at 16 rows no path runs out of its budget, so the
# fused schedule's bar is met with room (see the docstring)
_RENDER = dict(width=16, height=16, max_steps=128, max_bounces=2,
               max_dist=100.0)
_TRAIN = dict(width=16, height=8, max_steps=32, max_bounces=2,
              max_dist=100.0)
LAYOUTS = [((4, 1), 16, 4), ((1, 4), 16, 4), ((2, 2), 16, 4),
           ((2, 4), 16, 4)]
# rows the tile axis does not divide (12 rows on 8 tiles: ceil 2 rows a
# tile, the last two tiles below the frame), an spp remainder, and both
PADDED = [((8, 1), 12, 4), ((1, 4), 16, 5), ((2, 2), 23, 3)]


def _mesh(layout):
    return tsharding.make_mesh(tsharding.ShardConfig(*layout), CPU8)


def _assert_schedule_close(want, got):
    d = np.abs(np.asarray(want) - np.asarray(got))
    assert float((d > 1e-5).mean()) < 1e-2, float((d > 1e-5).mean())
    assert float(d.max()) < 1e-2, float(d.max())


@pytest.fixture(scope="module")
def setup():
    js = jbuiltin.sphere_on_floor()
    jp = js.init_params()
    corners = JCamera(aspect=1.0).corner_rays_flat()
    ts = tbuiltin.sphere_on_floor()
    return js, jp, corners, ts, params_from_numpy(np_tree(jp), "cpu"), \
        corners_to_torch(corners)


@pytest.fixture(scope="module")
def renders(setup):
    """Memoised renders: ("jax", layout, height, spp) is the JAX package's
    oracle `render_sharded` (its fused kernel equals it bit for bit,
    tests/test_parallel.py), ("one", impl, height, spp) the port's
    one-device render."""
    js, jp, jc, ts, tp, tc = setup
    cache = {}

    def get(key):
        if key not in cache:
            kind, what, height, spp = key
            if kind == "jax":
                cache[key] = np.asarray(jsharding.render_sharded(
                    js, jp, JCfg(**_RENDER).replace(height=height), jc,
                    jsharding.make_mesh(jsharding.ShardConfig(*what)), spp))
            else:
                cache[key] = tsharding.render_sharded(
                    ts, tp, TCfg(**_RENDER).replace(height=height), tc, spp,
                    impl=what)
        return cache[key]

    return get


def test_auto_shard_matches_jax():
    for n in range(1, 17):
        j = jsharding.auto_shard(n)
        assert tsharding.auto_shard(n) == tsharding.ShardConfig(j.tile,
                                                                j.spp), n
    with pytest.raises(ValueError, match="need 1 device"):
        tsharding.auto_shard(0)


def test_make_mesh_layout_matches_jax():
    """Positions are the devices in order, tile-major, as in the JAX
    package's mesh; a repeated device gives virtual positions."""
    for tile, spp in [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)]:
        jm = jsharding.make_mesh(jsharding.ShardConfig(tile, spp))
        tm = tsharding.make_mesh(tsharding.ShardConfig(tile, spp),
                                 [torch.device("cpu", i) for i in range(8)])
        assert tm.shape == dict(jm.shape)
        assert [[d.index for d in row] for row in tm.devices] == \
            [[d.id for d in row] for row in jm.devices]
        assert tm.ranks == ((0,) * spp,) * tile and tm.rank == 0
        assert len(tm.local_positions()) == tile * spp
    virtual = tsharding.make_mesh(tsharding.ShardConfig(2, 2), CPU8)
    assert {d for row in virtual.devices for d in row} == {CPU8[0]}


def test_make_mesh_refuses_too_few_devices():
    """As the JAX package: ValueError("need N devices, have M"), whether
    the devices are given or, on a machine without a card, taken from the
    visible CUDA devices (there is no fallback to the CPU)."""
    with pytest.raises(ValueError) as jerr:
        jsharding.make_mesh(jsharding.ShardConfig(tile=64, spp=64))
    with pytest.raises(ValueError) as terr:
        tsharding.make_mesh(tsharding.ShardConfig(tile=64, spp=64), CPU8)
    assert str(terr.value) == str(jerr.value) == "need 4096 devices, have 8"
    with pytest.raises(ValueError, match="need 4096 devices"):
        tsharding.make_mesh(tsharding.ShardConfig(tile=64, spp=64))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            tsharding.make_mesh(tsharding.ShardConfig())


def test_replicated_params_and_gather(setup):
    """`render_replicated_params` leaves a tree where it is (one copy per
    distinct device); `gather_image` is the host copy."""
    _, _, _, _, tp, _ = setup
    rep = tsharding.render_replicated_params(None, tp, _mesh((2, 2)))
    assert list(rep) == [torch.device("cpu")] and rep[torch.device("cpu")] \
        is tp
    img = torch.arange(12.0).reshape(2, 2, 3)
    np.testing.assert_array_equal(tsharding.gather_image(img), img.numpy())


@pytest.mark.parametrize("impl", ["oracle", "fused"])
@pytest.mark.parametrize("layout,height,spp", LAYOUTS + PADDED,
                         ids=lambda v: str(v))
def test_render_sharded(setup, renders, impl, layout, height, spp):
    _, _, _, ts, tp, tc = setup
    cfg = TCfg(**_RENDER).replace(height=height)
    got = tsharding.render_sharded(ts, tp, cfg, tc, spp, impl=impl,
                                   mesh=_mesh(layout))
    one = renders(("one", impl, height, spp))
    want = renders(("jax", layout, height, spp))
    assert got.shape == (height, 16, 3) and bool(torch.isfinite(got).all())
    if layout[1] == 1:
        assert torch.equal(got, one)
    elif impl == "oracle":
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5,
                                   atol=1e-6)
    else:
        _assert_schedule_close(one, got)
    if impl == "oracle":
        assert frac_off(want, got.numpy()) < MAX_FRAC_OFF
    else:
        _assert_schedule_close(want, got)


def _slices(launch, cfg, layout, spp, sample0):
    """The merge written out by hand: each position's raw sum at its
    shifted start (`launch(origin, patch, s0, n)`), the tile's parts in si
    order, the tiles in row order, one divide by spp."""
    n_tile, n_spp = layout
    rows = -(-cfg.height // n_tile)
    per, rem = divmod(spp, n_spp)
    tiles = []
    for ti in range(n_tile):
        patch = (min(rows, cfg.height - ti * rows), cfg.width)
        if patch[0] <= 0:
            break
        tile = None
        for si in range(n_spp):
            acc = None
            if per:
                acc = launch((0, ti * rows), patch, sample0 + si * per, per)
            if si < rem:
                extra = launch((0, ti * rows), patch,
                               sample0 + n_spp * per + si, 1)
                acc = extra if acc is None else acc + extra
            if acc is not None:
                tile = acc if tile is None else tile + acc
        tiles.append(tile)
    return torch.cat(tiles, 0) / float(spp)


@pytest.mark.parametrize("frame", [0, 1])
def test_render_sharded_spectral(frame):
    """Frame `frame` of a progressive render at sample0 = frame * spp:
    (4, 1) byte-equal to the one launch at that start; (2, 2) byte-equal
    to its positions' slices at the shifted starts, and within the fused
    bar of the one launch and (frame 0) of the JAX package's
    `render_sharded_spectral` (interpret mode; it has no sample0).
    Measured: 0 values off by more than 1e-5 in both."""
    from raymarchrenderer_tpu_torch.kernels.march import (
        render_fused_spectral)
    js, jp, jm = jspec.spectral_demo()
    jc = JCamera(aspect=1.0).corner_rays_flat()
    ts = tspec.spectral_demo("cpu")[0]
    tp, tm, tc = (params_from_numpy(np_tree(jp), "cpu"), mats_to_torch(jm),
                  corners_to_torch(jc))
    cfg = TCfg(**_RENDER)
    s0 = 4 * frame
    one = tsharding.render_sharded_spectral(ts, tp, tm, cfg, tc, 4,
                                            sample0=s0)
    tiles = tsharding.render_sharded_spectral(ts, tp, tm, cfg, tc, 4,
                                              mesh=_mesh((4, 1)), sample0=s0)
    assert torch.equal(tiles, one)
    got = tsharding.render_sharded_spectral(ts, tp, tm, cfg, tc, 4,
                                            mesh=_mesh((2, 2)), sample0=s0)
    want = _slices(lambda origin, patch, a, n: render_fused_spectral(
        ts, tp, tm, cfg, tc, a, n_samples=n, origin_xy=origin,
        patch_shape=patch, normalize=False), cfg, (2, 2), 4, s0)
    assert torch.equal(got, want)
    _assert_schedule_close(one, got)
    if frame:
        first = tsharding.render_sharded_spectral(ts, tp, tm, cfg, tc, 4,
                                                  mesh=_mesh((2, 2)))
        assert not torch.equal(first, got)
        return
    want = np.asarray(jsharding.render_sharded_spectral(
        js, jp, jm, JCfg(**_RENDER), jc,
        jsharding.make_mesh(jsharding.ShardConfig(2, 2)), 4, interpret=True))
    _assert_schedule_close(want, got)
    assert frac_off(want, got.numpy()) < MAX_FRAC_OFF


@pytest.mark.parametrize("impl", ["oracle", "fused"])
@pytest.mark.parametrize("layout,height,spp", [((2, 2), 16, 4),
                                               ((1, 4), 16, 5)],
                         ids=lambda v: str(v))
def test_render_sharded_continues_the_sequence(setup, impl, layout, height,
                                               spp):
    """The RGB render at sample0 = spp (the progressive sequence's second
    frame) is its positions' slices at the shifted starts, the spp
    remainder's extra sample shifted too, byte for byte."""
    from raymarchrenderer_tpu_torch.kernels.march import render_fused_patch
    from raymarchrenderer_tpu_torch.render.integrator import render_patch
    _, _, _, ts, tp, tc = setup
    cfg = TCfg(**_RENDER).replace(height=height)
    got = tsharding.render_sharded(ts, tp, cfg, tc, spp, impl=impl,
                                   mesh=_mesh(layout), sample0=spp)

    def launch(origin, patch, s0, n):
        if impl == "fused":
            return render_fused_patch(ts, tp, cfg, tc, origin, patch, s0,
                                      n_samples=n, normalize=False)
        acc = torch.zeros((*patch, 3), dtype=torch.float32)
        for s in range(s0, s0 + n):
            acc = acc + render_patch(ts, tp, cfg, tc, origin, patch,
                                     s).stack(-1)
        return acc

    assert torch.equal(got, _slices(launch, cfg, layout, spp, spp))


def test_render_merged_places_then_launches_then_merges(monkeypatch):
    """The three phases of `_render_merged`, recorded through four
    distinct (virtual) devices: every device's inputs placed before the
    first launch, every position launched before the merge; each
    position's placement and launch in an `rmr.position` span, the merge
    in one `rmr.merge` span."""
    from raymarchrenderer_tpu_torch.kernels import march
    ts, tp, tm = tspec.spectral_demo("cpu")
    tc = corners_to_torch(JCamera(aspect=1.0).corner_rays_flat())
    cfg = TCfg(**dict(_RENDER, width=8, height=8, max_steps=32))
    devices = [torch.device("cpu", i) for i in range(4)]
    mesh = tsharding.make_mesh(tsharding.ShardConfig(2, 2), devices)
    events = []
    tree_to, merge = tsharding._tree_to, tsharding._merge
    fused = march.render_fused_spectral

    def placed(tree, device):
        events.append(("place", device.index))
        return tree_to(tree, device)

    def launched(*args, **kw):
        events.append(("launch", kw["origin_xy"], args[5]))
        return fused(*args, **kw)

    def merged(parts, *args):
        events.append(("merge", tuple(sorted(parts))))
        return merge(parts, *args)

    monkeypatch.setattr(tsharding, "_tree_to", placed)
    monkeypatch.setattr(tsharding, "_merge", merged)
    monkeypatch.setattr(march, "render_fused_spectral", launched)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tsharding.render_sharded_spectral(ts, tp, tm, cfg, tc, 4, mesh=mesh,
                                          sample0=8)
    kinds = [e[0] for e in events]
    assert kinds == ["place"] * 8 + ["launch"] * 4 + ["merge"], events
    assert [e[1] for e in events[:8]] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [e[1:] for e in events[8:12]] == [((0, 0), 8), ((0, 0), 10),
                                             ((0, 4), 8), ((0, 4), 10)]
    assert events[-1][1] == ((0, 0), (0, 1), (1, 0), (1, 1))
    names = [e.name for e in prof.events()]
    assert names.count("rmr.position") == 8
    assert names.count("rmr.merge") == 1


@pytest.fixture(scope="module")
def train_setup(setup):
    js, jp, jc, ts, tp, tc = setup
    target = np.random.RandomState(7).uniform(
        0.0, 0.5, (8, 16, 3)).astype(np.float32)
    loss, grads = tsharding.train_grads_sharded(
        ts, tp, TCfg(**_TRAIN), tc, torch.from_numpy(target), 2,
        march_impl="recorded")
    return target, float(loss), [g.numpy() for g in param_leaves(grads)]


@pytest.mark.parametrize("layout", [(2, 2), (4, 2)])
def test_train_step_sharded(setup, train_setup, layout):
    """The port's sharded step takes the one-position step's update (the
    true gradient); the JAX package's takes tile * spp times it."""
    js, jp, jc, ts, tp, tc = setup
    target, loss1, grads1 = train_setup
    factor = layout[0] * layout[1]
    mesh = _mesh(layout)
    loss, new_p = tsharding.train_step_sharded(
        ts, tp, TCfg(**_TRAIN), tc, torch.from_numpy(target), 2, lr=1.0,
        march_impl="recorded", mesh=mesh)
    fwd = tsharding.train_loss_sharded(
        ts, tp, TCfg(**_TRAIN), tc, torch.from_numpy(target), 2,
        march_impl="recorded", mesh=mesh)
    jmesh = jsharding.make_mesh(jsharding.ShardConfig(*layout))
    with jmesh:
        jloss, jnew = jsharding.train_step_sharded(
            js, jp, JCfg(**_TRAIN), jc, jnp.asarray(target), jmesh, spp=2,
            lr=1.0, march_impl="recorded", interpret=True)
    np.testing.assert_allclose(float(loss), loss1, rtol=1e-6)
    np.testing.assert_allclose(float(fwd), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    moved = 0
    for p0, p1, g1, jp1 in zip(param_leaves(tp), param_leaves(new_p),
                               grads1, jax.tree.leaves(jnew)):
        if not g1.size:
            continue
        p0 = p0.numpy().astype(np.float64)
        upd = p0 - p1.numpy()
        jupd = (p0 - np.asarray(jp1, np.float64)) / factor
        scale = float(np.abs(g1).max())
        # the update p - (p - g) in float32 is g to half an ulp of p
        ulp = float(np.spacing(np.abs(p0).max().astype(np.float32)))
        np.testing.assert_allclose(upd, g1, rtol=0, atol=1e-5 * scale + ulp)
        np.testing.assert_allclose(upd, jupd, rtol=0,
                                   atol=1e-4 * scale + 2 * ulp)
        moved += int(scale > 0)
    assert moved > 0


def test_train_step_spectral_sharded():
    """(2, 2) against the one-position step and the JAX package's (its
    oracle march: no jax.grad through an interpret-mode kernel; the
    port's recorded).  sphere_on_floor's scene leaves get no gradient in
    either package, so the factor does not show; the band rows step by
    sign and must match.  Measured: band gradients within 8.4e-8 of the
    one-position step's max, the loss within 6.3e-8 of JAX's."""
    js, jp, jm = jspec.spectral_demo()
    jc = JCamera(aspect=1.0).corner_rays_flat()
    ts = tspec.spectral_demo("cpu")[0]
    tp, tm, tc = (params_from_numpy(np_tree(jp), "cpu"), mats_to_torch(jm),
                  corners_to_torch(jc))
    target = np.random.RandomState(4).uniform(
        0.0, 0.3, (8, 16, 3)).astype(np.float32)
    args = (ts, tp, tm, TCfg(**_TRAIN), tc, torch.from_numpy(target), 2)
    l1, g1, b1 = tsharding.train_grads_spectral_sharded(
        *args, march_impl="recorded", sample0=6)
    mesh = _mesh((2, 2))
    loss, grads, bands = tsharding.train_grads_spectral_sharded(
        *args, march_impl="recorded", sample0=6, mesh=mesh)
    _, new_m = tsharding.spectral_update(tp, tm, grads, bands, 1.0)
    jmesh = jsharding.make_mesh(jsharding.ShardConfig(2, 2))
    with jmesh:
        jloss, _, jnew_m = jsharding.train_step_spectral_sharded(
            js, jp, jm, JCfg(**_TRAIN), jc, jnp.asarray(target), jmesh,
            spp=2, lr=1.0, march_impl="oracle", interpret=True, sample0=6)
    np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, g0 in zip(param_leaves(grads) + list(bands),
                     param_leaves(g1) + list(b1)):
        scale = float(g0.abs().max()) if g0.numel() else 0.0
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=0,
                                   atol=1e-5 * scale)
    for a, b, b0 in zip(new_m[:3], jnew_m[:3], tm[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not np.array_equal(a.numpy(), b0.numpy())


@pytest.mark.parametrize("height,spp", [(10, 2), (8, 3)],
                         ids=["rows", "samples"])
def test_train_layout_must_divide(setup, height, spp):
    """Train steps keep the JAX package's limit: a height or spp the
    layout does not divide raises the same ValueError."""
    js, jp, jc, ts, tp, tc = setup
    cfg = dict(_TRAIN, height=height)
    target = np.zeros((height, 16, 3), np.float32)
    jmesh = jsharding.make_mesh(jsharding.ShardConfig(4, 2))
    with pytest.raises(ValueError) as jerr:
        jsharding.train_step_sharded(js, jp, JCfg(**cfg), jc,
                                     jnp.asarray(target), jmesh, spp=spp)
    mesh = _mesh((4, 2))
    t = torch.from_numpy(target)
    for fn in (tsharding.train_step_sharded, tsharding.train_loss_sharded,
               tsharding.train_grads_sharded):
        with pytest.raises(ValueError) as terr:
            fn(ts, tp, TCfg(**cfg), tc, t, spp, mesh=mesh)
        assert str(terr.value) == str(jerr.value)
    mats = tspec.band_table(ts, "cpu")
    with pytest.raises(ValueError, match="height/spp must divide"):
        tsharding.train_step_spectral_sharded(ts, tp, mats, TCfg(**cfg), tc,
                                              t, spp, mesh=mesh)
