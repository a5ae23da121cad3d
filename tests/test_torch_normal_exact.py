"""Port parity, the exact normal (`normal_taps=0`): the gradient of the
scene map by one reverse sweep, against the JAX package's `jax.grad` /
`jax.vjp`.

  * per object node: the gradient of each of the 20 nodes w.r.t. every
    input (the point and the parameters), at seeded points and at the
    kinks where torch's own derivatives differ from JAX's: min / max ties
    (0.5 / 0.5), `abs` at 0 (JAX 1, torch 0), `clip` at its bounds, a
    point inside a cylinder (NaN in JAX: sqrt'(0) * 0), a point on a
    torus's axis.  NaN is compared as NaN, but for one point: a capsule
    whose endpoints coincide, where JAX's divide derivative overflows
    (its endpoints' gradients NaN, the port's 0; the normal agrees).  Bar:
    rtol 1e-5, atol 2e-6
    (XLA:CPU's sqrt, rsqrt, sin and cos are an ulp off the correctly
    rounded ones, and JAX's sqrt' is g * (0.5 / y) where torch's is
    g / (2 y));
  * the running minimum over objects: a three-way tie splits 0.25 / 0.25
    / 0.5, as `jnp.minimum`'s chain from object 0 does;
  * per scene: `get_normal(normal_taps=0)` at the hit points of a JAX
    march of a 32^2 plane of primary rays, on every builtin and scene
    file, and on the all-nodes scene (torus, cylinder, capsule, box,
    smooth union, repeat, plane, the arithmetic nodes), under the
    1.5e-4 normal bar of `test_torch_scene.py::test_get_normal`.

The kernels' reverse sweep (`grad_map`, csrc/scene_map.cuh) repeats the
plain version's backward formulas; `tests/test_torch_cuda.py` holds it
against them on the card.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ALL_NODES_SCENE, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.core.rng import RNGStream as JRNG
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.render.raygen import (eye_vec, pixel_grid,
                                                primary_rays)
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu.scene import nodes as jnodes
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import nodes as tnodes
from raymarchrenderer_tpu_torch.scene import param_leaves, params_from_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 2e-6
NORMAL_TOL = 1.5e-4


def _rand(rs, n, lo, hi):
    return rs.uniform(lo, hi, (3, n)).astype(np.float32)


# node -> (seeded inputs(rs, n), kink rows): each input a (3, n) array;
# each kink row one value per input (a 3-tuple each)
def _kinks(*rows):
    return [tuple(np.float32(v) for v in row) for row in rows]


_NODES = {
    "map_sphere": (lambda rs, n: [_rand(rs, n, -2, 2), _rand(rs, n, -1, 1),
                                  _rand(rs, n, 0.3, 1.5)],
                   _kinks(((0.3, 1, 0), (0.3, 1, 0), (1, 1, 1)))),
    "map_box": (lambda rs, n: [_rand(rs, n, -2, 2), _rand(rs, n, -1, 1),
                               _rand(rs, n, 0.2, 1.5)],
                _kinks(((0.5, 0.5, 0.0), (0, 0, 0), (1, 1, 2)),   # diagonal
                       ((0.0, 0.3, 0.2), (0, 0, 0), (1, 1, 2)),   # abs at 0
                       ((1.0, 0.2, 0.1), (0, 0, 0), (1, 1, 2)),   # on a face
                       ((1.0, 1.0, 2.0), (0, 0, 0), (1, 1, 2)),   # a corner
                       ((0.0, 0.0, 0.0), (0, 0, 0), (1, 1, 1)))),  # centre
    "map_plane": (lambda rs, n: [_rand(rs, n, -2, 2), _rand(rs, n, -1, 1),
                                 _rand(rs, n, -1, 1)],
                  _kinks(((1, 2, 3), (0, 1, 0), (0.5, 0, 0)))),
    "map_torus": (lambda rs, n: [_rand(rs, n, -2, 2), _rand(rs, n, -0.5, 0.5),
                                 np.stack([rs.uniform(0.8, 1.5, n),
                                           rs.uniform(0.1, 0.4, n),
                                           np.zeros(n)]).astype(np.float32)],
                  _kinks(((0.0, 0.5, 0.0), (0, 0, 0), (1.0, 0.3, 0)),  # axis
                         ((1.0, 0.0, 0.0), (0, 0, 0), (1.0, 0.3, 0)))),
    "map_cylinder": (lambda rs, n: [_rand(rs, n, -2, 2),
                                    _rand(rs, n, -0.5, 0.5),
                                    _rand(rs, n, 0.2, 1.0)],
                     _kinks(((0.5, 0.2, 0.1), (0, 0, 0), (1.0, 1.0, 0)),
                            ((0.6, 0.0, 0.0), (0, 0, 0), (0.5, 1.0, 0)),
                            ((2.0, 0.0, 0.0), (0, 0, 0), (0.5, 1.0, 0)),
                            ((1.5, 2.0, 0.0), (0, 0, 0), (1.0, 1.5, 0)))),
    "map_capsule": (lambda rs, n: [_rand(rs, n, -2, 2),
                                   _rand(rs, n, -1, 0), _rand(rs, n, 0, 1),
                                   _rand(rs, n, 0.1, 0.5)],
                    _kinks(((0.5, 0.0, 0.0), (0, 0, 0), (0, 1, 0),
                            (0.3, 0.3, 0.3)),                  # h = 0
                           ((0.5, 1.0, 0.0), (0, 0, 0), (0, 1, 0),
                            (0.3, 0.3, 0.3)),                  # h = 1
                           ((0.5, 0.5, 0.0), (0, 0, 0), (0, 0, 0),
                            (0.3, 0.3, 0.3)))),                # a == b
    "op_union": (lambda rs, n: [_rand(rs, n, -1, 1), _rand(rs, n, -1, 1)],
                 _kinks(((0.5, -0.2, 0), (0.5, 0.3, 0)))),
    "op_subtract": (lambda rs, n: [_rand(rs, n, -1, 1), _rand(rs, n, -1, 1)],
                    _kinks(((0.5, -0.2, 0), (-0.5, 0.2, 0)))),
    "op_intersect": (lambda rs, n: [_rand(rs, n, -1, 1),
                                    _rand(rs, n, -1, 1)],
                     _kinks(((0.5, -0.2, 0), (0.5, -0.2, 1)))),
    "op_smooth_union": (lambda rs, n: [_rand(rs, n, -1, 1),
                                       _rand(rs, n, -1, 1),
                                       _rand(rs, n, 0.1, 0.5)],
                        _kinks(((0.5, 0, 0), (0.25, 0, 0), (0.25, 0, 0)),
                               ((0.25, 0, 0), (0.5, 0, 0), (0.25, 0, 0)),
                               ((0.3, 0, 0), (0.3, 0, 0), (0.2, 0, 0)))),
    "domain_repeat": (lambda rs, n: [_rand(rs, n, -5, 5),
                                     _rand(rs, n, 0.5, 3)],
                      _kinks(((2.0, -3.0, 0.7), (2.0, 1.5, 0.0)),
                             ((-4.0, 0.0, 1.0), (2.0, 0.0, 3.0)))),
    "misc_getX": (lambda rs, n: [_rand(rs, n, -1, 1)], []),
    "misc_getY": (lambda rs, n: [_rand(rs, n, -1, 1)], []),
    "misc_getZ": (lambda rs, n: [_rand(rs, n, -1, 1)], []),
    "math_add": (lambda rs, n: [_rand(rs, n, -1, 1), _rand(rs, n, -1, 1)],
                 []),
    "math_subtract": (lambda rs, n: [_rand(rs, n, -1, 1),
                                     _rand(rs, n, -1, 1)], []),
    "math_multiply": (lambda rs, n: [_rand(rs, n, -1, 1),
                                     _rand(rs, n, -1, 1)], []),
    "math_divide": (lambda rs, n: [_rand(rs, n, -1, 1),
                                   _rand(rs, n, 0.5, 2)], []),
    "math_sine": (lambda rs, n: [_rand(rs, n, -4, 4)], []),
    "math_cosine": (lambda rs, n: [_rand(rs, n, -4, 4)], []),
}


def _node_inputs(name):
    make, kinks = _NODES[name]
    ins = make(np.random.RandomState(sorted(_NODES).index(name)), 64)
    if kinks:
        extra = [np.stack([np.asarray(row[i], np.float32) for row in kinks],
                          axis=1) for i in range(len(ins))]
        ins = [np.concatenate([a, e], axis=1) for a, e in zip(ins, extra)]
    return ins


def _node_grads_jax(name, ins):
    fn = jnodes.OBJECT_NODES[name]

    def f(*flat):
        vs = [JVec3(*flat[3 * i:3 * i + 3]) for i in range(len(ins))]
        out = fn(*vs)[0]
        return jnp.sum(out.x + 0.5 * out.y + 0.25 * out.z)

    flat = [jnp.asarray(c) for a in ins for c in a]
    return [np.asarray(g) for g in
            jax.grad(f, argnums=tuple(range(len(flat))))(*flat)]


def _node_grads_torch(name, ins):
    fn = tnodes.OBJECT_NODES[name]
    flat = [torch.tensor(c, requires_grad=True) for a in ins for c in a]
    vs = [TVec3(*flat[3 * i:3 * i + 3]) for i in range(len(ins))]
    out = fn(*vs)[0]
    s = (out.x + 0.5 * out.y + 0.25 * out.z).sum()
    gs = torch.autograd.grad(s, flat, allow_unused=True)
    return [np.zeros_like(c.detach().numpy()) if g is None else g.numpy()
            for g, c in zip(gs, flat)]


@pytest.mark.parametrize("name", sorted(_NODES))
def test_node_gradient_matches_jax(name):
    """Every input's gradient of every object node, the kinks included.
    The values of the nodes stay torch's (core/sdf.py changes only their
    derivatives), so the forward is held bitwise to the unchanged ops."""
    assert set(_NODES) == set(tnodes.OBJECT_NODES) == set(
        jnodes.OBJECT_NODES)
    ins = _node_inputs(name)
    want = _node_grads_jax(name, ins)
    got = _node_grads_torch(name, ins)
    if name == "map_capsule":
        # the degenerate capsule (last row, a == b): JAX's divide
        # derivative -g x y^-2 overflows at y = 1e-30 (its floor of
        # |b - a|^2) and makes the endpoints' gradients NaN, where torch's
        # -g (x / y) / y adds 0; the point's gradient, the normal, agrees
        for k in range(3, 9):
            assert np.isnan(want[k][-1]) and np.isfinite(got[k][-1])
            want[k], got[k] = want[k][:-1], got[k][:-1]
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   equal_nan=True,
                                   err_msg=f"{name}, input {k // 3} "
                                           f"component {k % 3}")


def test_kinks_take_jax_derivatives():
    """The rules the kinks above rest on, value by value: abs' (0) = 1, a
    tie of min / max / clip splits 0.5 / 0.5, a box's inside diagonal
    0.5 / 0.5 / 0, and a point inside a cylinder has a NaN gradient."""
    def grad_of(name, *vals):
        ins = [np.asarray(v, np.float32).reshape(3, 1) for v in vals]
        return np.concatenate(_node_grads_torch(name, ins)).ravel()

    box = grad_of("map_box", (0.5, 0.5, 0.0), (0, 0, 0), (1, 1, 2))[:3]
    np.testing.assert_array_equal(box, np.float32([0.875, 0.875, 0.0]))
    cyl = grad_of("map_cylinder", (0.5, 0.2, 0.1), (0, 0, 0), (1, 1, 0))
    assert np.isnan(cyl[:3]).all()
    union = grad_of("op_union", (0.5, 0, 0), (0.5, 0, 0))
    np.testing.assert_array_equal(union[[0, 3]], np.float32([0.5, 0.5]))
    from raymarchrenderer_tpu_torch.core.sdf import jabs, jclamp
    x = torch.tensor([0.0, -0.0, 0.0, 1.0, -1.0], requires_grad=True)
    (gx,) = torch.autograd.grad(jabs(x).sum(), x)
    np.testing.assert_array_equal(gx.numpy(), [1, 1, 1, 1, -1])
    (gx,) = torch.autograd.grad(jclamp(x, 0.0, 1.0).sum(), x)
    np.testing.assert_array_equal(gx.numpy(), [0.5, 0.5, 0.5, 0.5, 0.0])
    # the values are torch's, the sign of a zero included
    y = torch.tensor([-0.0, 0.0, -2.0, 0.5])
    for a, b in ((jabs(y), torch.abs(y)),
                 (jclamp(y, 0.0, 1.0), torch.clamp(y, 0.0, 1.0)),
                 (jclamp(y, hi=0.0), torch.clamp(y, max=0.0))):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def _tie_scene(lib):
    b = lib.SceneBuilder()
    m = b.diffuse([0.5, 0.5, 0.5])
    for c in ([1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]):
        b.sphere(m, c, 1.0)
    return b.build()


def test_three_way_tie_splits_like_jax():
    """Three unit spheres touching at the origin: the running minimum from
    object 0 gives the cotangents 0.25 / 0.25 / 0.5, so the gradient is
    (0, -0.5, 0), not a third of each."""
    js, ts = _tie_scene(jbuiltin), _tie_scene(tbuiltin)
    pts = np.zeros((3, 1), np.float32)

    def jgrad(x, y, z):
        return js.map_dist(js.init_params(), JVec3(x, y, z), 100.0)

    _, pull = jax.vjp(jgrad, *(jnp.asarray(c) for c in pts))
    want = np.stack([np.asarray(g) for g in pull(jnp.ones(1, jnp.float32))])
    got = tint.exact_gradient(ts, ts.init_params("cpu"), TCfg(normal_taps=0),
                              TVec3(*(torch.from_numpy(c) for c in pts)))
    np.testing.assert_array_equal(want[:, 0], [0.0, -0.5, 0.0])
    np.testing.assert_array_equal(np.stack([c.numpy() for c in got])[:, 0],
                                  want[:, 0])


_CAMERAS = {"cornell": ((0.0, 2.0, 7.0), (0.0, 2.0, 0.0))}
_SCENES = (["sphere_on_floor", "single_sphere", "csg_demo", "cornell",
            "glass_demo", "volume_demo", "spectral_demo", "all_nodes"]
           + sorted(os.path.basename(f) for f in glob.glob(
               os.path.join(_REPO, "data", "scenes", "*.scene"))))


def _scene_pair(name):
    if name == "spectral_demo":
        js, jp, _ = jspec.spectral_demo()
        ts, tp, _ = tspec.spectral_demo("cpu")
        return js, jp, ts, tp
    if hasattr(tbuiltin, name):
        js, ts = getattr(jbuiltin, name)(), getattr(tbuiltin, name)()
    else:
        text = ALL_NODES_SCENE if name == "all_nodes" else open(
            os.path.join(_REPO, "data", "scenes", name)).read()
        js, ts = jgraph.loads_scene(text), tgraph.loads_scene(text)
    jp = js.init_params()
    return js, jp, ts, params_from_numpy(np_tree(jp), "cpu")


def _march_hits(js, jp, name):
    """The hit points of a JAX march of a 32^2 plane of primary rays."""
    cam = JCamera(aspect=1.0)
    if name in _CAMERAS:
        cam.eye = _CAMERAS[name][0]
        cam.look_at(_CAMERAS[name][1])
    corners = cam.corner_rays_flat()
    px, py = pixel_grid(32, 32)
    rng = JRNG(0, px, py, jnp.uint32(0), jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, 32, 32, rng)
    e = eye_vec(corners)
    eye = JVec3(*(jnp.broadcast_to(c, (32, 32)) for c in e))
    cfg = JCfg(width=32, height=32, max_steps=128, max_dist=100.0)
    t, _, hit = jint.march(js, jp, cfg, eye, d, 1.0,
                           jnp.ones((32, 32), jnp.int32))
    p = eye + d * t
    keep = np.asarray(hit)
    return np.stack([np.asarray(c)[keep] for c in p])


@pytest.mark.parametrize("name", _SCENES)
def test_exact_normal_at_march_hits(name):
    """Every component within 1.5e-4 of JAX's exact normal at a JAX
    march's hit points (NaN where JAX's is NaN)."""
    js, jp, ts, tp = _scene_pair(name)
    pts = _march_hits(js, jp, name)
    assert pts.shape[1] > 50
    jn = jint.get_normal(js, jp, JCfg(normal_taps=0, max_dist=100.0),
                         JVec3(*(jnp.asarray(c) for c in pts)))
    tn = tint.get_normal(ts, tp, TCfg(normal_taps=0, max_dist=100.0),
                         TVec3(*(torch.from_numpy(c.copy()) for c in pts)))
    want = np.stack([np.asarray(c) for c in jn])
    got = np.stack([c.numpy() for c in tn])
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL,
                               equal_nan=True)


def test_exact_normal_carries_its_derivatives():
    """Under grad mode the normal keeps its graph: d(normal . w)/d(radius)
    and d/dp equal jax.grad through the JAX package's jax.vjp normal
    (the second-order term of the train replays)."""
    text = ALL_NODES_SCENE
    js, ts = jgraph.loads_scene(text), tgraph.loads_scene(text)
    jp = js.init_params()
    pts = np.random.RandomState(7).uniform(-3, 3, (3, 256)).astype(
        np.float32)
    w = np.float32([0.3, -0.7, 0.5])
    jcfg = JCfg(normal_taps=0, max_dist=100.0)
    # away from the cylinder's inside, where the normal itself is NaN
    n0 = jint.get_normal(js, jp, jcfg, JVec3(*(jnp.asarray(c) for c in pts)))
    pts = pts[:, np.isfinite(np.stack([np.asarray(c) for c in n0])).all(0)]

    def jloss(params, x, y, z):
        n = jint.get_normal(js, params, jcfg, JVec3(x, y, z))
        return jnp.sum(n.x * w[0] + n.y * w[1] + n.z * w[2])

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jp, *(jnp.asarray(c) for c in pts))
    tp = params_from_numpy(np_tree(jp), "cpu")
    leaves = [leaf.requires_grad_(True) for leaf in param_leaves(tp)]
    q = [torch.tensor(c, requires_grad=True) for c in pts]
    n = tint.get_normal(ts, tp, TCfg(normal_taps=0, max_dist=100.0),
                        TVec3(*q))
    loss = torch.sum(n.x * float(w[0]) + n.y * float(w[1])
                        + n.z * float(w[2]))
    tg = torch.autograd.grad(loss, leaves + q, allow_unused=True)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg[0])] + [
        np.asarray(x) for x in jg[1:]]
    got = [np.zeros(l.shape, np.float32) if g is None else g.numpy()
           for g, l in zip(tg, leaves + q)]
    assert len(want) == len(got)
    for k, (a, b) in enumerate(zip(want, got)):
        scale = max(float(np.abs(a).max()), 1.0) if a.size else 1.0
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"leaf {k}")



@pytest.mark.parametrize("taps", [4, 0])
def test_train_step_leaves_no_tensors_alive(taps):
    """A train step under remat (the checkpointed replay) leaves no tensor
    alive once its loss and gradients are dropped: the exact normal's
    kept graph packs its saved tensors as data (a saved output packed
    with its own grad_fn would hold its node in a cycle the collector
    cannot see), and core/sdf.py's Functions save no output."""
    import gc
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.parallel import sharding
    scene = tbuiltin.csg_demo()
    params = scene.init_params("cpu")
    cfg = TCfg(width=8, height=8, max_steps=48, max_bounces=2,
               relax_omega=1.9, normal_taps=taps)
    corners = Camera(aspect=1.0).corner_rays_flat("cpu")
    target = torch.full((8, 8, 3), 0.2)

    def alive():
        gc.collect()
        return {id(o) for o in gc.get_objects() if torch.is_tensor(o)}

    before = alive()
    loss, grads = sharding.train_grads_sharded(
        scene, params, cfg, corners, target, 1, direct_light=True,
        march_impl="oracle", remat=True)
    assert float(loss) > 0.0
    del loss, grads
    assert not alive() - before
