"""Port parity, materials: `RNGStream.fork`, the vector and sampling
helpers of the RGB transport, every material node, `Scene.shade`, and the
per-material RNG bases the kernel's material program starts from.

`fork` and `reflect` are bitwise.  The rest agrees to a stated absolute
bound: `Vec3.normalized` is 1/sqrt in the port and `lax.rsqrt` in JAX
(1 ulp apart in about a third of inputs), and torch's sqrt, sin, cos and
pow differ from XLA:CPU's by an ulp in a few percent.  A shader's
direction passes through at most a few of those, so 1e-5 bounds it; a
material whose random select or scatter decision sits within an ulp of its
threshold would differ by a whole branch, which the inputs here never hit
(measured: every shading output matches to 1e-5 or better).
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ALL_MATERIALS_SCENE, ALL_NODES_SCENE, np_tree

from raymarchrenderer_tpu.core import rng as jrng
from raymarchrenderer_tpu.core import sampling as jsampling
from raymarchrenderer_tpu.core import vecmath as jvec
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu.scene import nodes as jnodes
from raymarchrenderer_tpu_torch.core import rng as trng
from raymarchrenderer_tpu_torch.core import sampling as tsampling
from raymarchrenderer_tpu_torch.core import vecmath as tvec
from raymarchrenderer_tpu_torch.kernels import scene_program
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import nodes as tnodes
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N = 4096
ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.broadcast_to(np.asarray(got), np.shape(want)),
                               np.asarray(want), rtol=0, atol=atol)


def _vec_pair(a):
    """A (3, n) float32 array -> (JAX Vec3, torch Vec3)."""
    return (jvec.Vec3(*(jnp.asarray(c) for c in a)),
            tvec.Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a)))


def _unit(rs, n=_N):
    v = rs.normal(size=(3, n)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)


def test_fork_bitwise():
    """RR draws from fork(13), NEE from fork(7).fork(101 + li)."""
    rs = np.random.RandomState(0)
    px = rs.randint(0, 4096, size=(16, 64)).astype(np.int32)
    py = rs.randint(0, 4096, size=(16, 64)).astype(np.int32)
    sample = rs.randint(0, 2 ** 32, size=(16, 64), dtype=np.uint64)
    bounce = rs.randint(0, 17, size=(16, 64)).astype(np.int32)
    js = jrng.RNGStream(np.uint32(5), px, py, sample.astype(np.uint32), bounce)
    ts = trng.RNGStream(5, torch.from_numpy(px), torch.from_numpy(py),
                        torch.from_numpy(sample.astype(np.int64)),
                        torch.from_numpy(bounce))
    js.next()
    ts.next()
    for jf, tf in ((js.fork(13), ts.fork(13)),
                   (js.fork(7).fork(102), ts.fork(7).fork(102))):
        for _ in range(3):
            np.testing.assert_array_equal(np.asarray(jf.next()),
                                          tf.next().numpy())


def test_reflect_bitwise_and_refract():
    rs = np.random.RandomState(1)
    jd, td = _vec_pair(_unit(rs))
    jn, tn = _vec_pair(_unit(rs))
    for a, b in zip(jvec.reflect(jd, jn), tvec.reflect(td, tn)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    eta = rs.uniform(0.4, 2.5, _N).astype(np.float32)
    want = jvec.refract(jd, jn, jnp.asarray(eta))
    got = tvec.refract(td, tn, torch.from_numpy(eta))
    tir = np.asarray(want.dot(want)) == 0.0
    assert 0.05 < tir.mean() < 0.95          # both branches are exercised
    for a, b in zip(want, got):
        _close(b, a, atol=1e-6)               # sqrt: 1 ulp
    assert tvec.Vec3(*(torch.from_numpy(np.asarray(c)) for c in
                       _unit(rs, 4))).sum().shape == (4,)


def test_tbn_cosine_and_ggx():
    """make_tbn (with the exact n.x == 0 fallback), tbn_apply,
    cosine_hemisphere and ggx_lobe (roughness 0 included); measured max
    abs difference 2.6e-6 (normalisation, sqrt, sin, cos)."""
    rs = np.random.RandomState(2)
    n = _unit(rs)
    n[0, :16] = 0.0
    n[:, :16] /= np.linalg.norm(n[:, :16], axis=0, keepdims=True)
    jn, tn = _vec_pair(n)
    jl, tl = _vec_pair(_unit(rs))
    jt, tt = jsampling.make_tbn(jn), tsampling.make_tbn(tn)
    for jv, tv in zip(jt, tt):
        for a, b in zip(jv, tv):
            _close(b, a)
    for a, b in zip(jsampling.tbn_apply(jt, jl), tsampling.tbn_apply(tt, tl)):
        _close(b, a)
    u1, u2 = (rs.uniform(size=_N).astype(np.float32) for _ in range(2))
    rough = rs.uniform(0.0, 1.0, _N).astype(np.float32)
    rough[:32] = 0.0
    ju1, ju2, jr = jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(rough)
    tu1, tu2, tr = (torch.from_numpy(a) for a in (u1, u2, rough))
    for a, b in zip(jsampling.cosine_hemisphere(ju1, ju2),
                    tsampling.cosine_hemisphere(tu1, tu2)):
        _close(b, a)
    for a, b in zip(jsampling.ggx_lobe(ju1, ju2, jr),
                    tsampling.ggx_lobe(tu1, tu2, tr)):
        _close(b, a)


def _ctx_pair(seed: int, shape=(32, 64), channels="white"):
    """The same ShadeCtx in both packages, from seeded arrays: inside
    flags of both values, unit normals facing the ray, per-lane sample and
    bounce streams."""
    rs = np.random.RandomState(seed)
    n = int(np.prod(shape))
    d = _unit(rs, n)
    nrm = _unit(rs, n)
    nrm = np.where((d * nrm).sum(0) > 0, -nrm, nrm).astype(np.float32)
    origin = rs.uniform(-3, 3, (3, n)).astype(np.float32)
    t = rs.uniform(0.0, 3.0, n).astype(np.float32)
    hit = (origin + d * t).astype(np.float32)
    inside = (rs.uniform(size=n) < 0.5).astype(np.float32)
    if channels == "white":
        ch = np.ones((3, n), np.float32)
    else:
        ch = np.eye(3, dtype=np.float32)[:, rs.randint(0, 3, n)]
    px = rs.randint(0, 1024, n).astype(np.int32)
    py = rs.randint(0, 1024, n).astype(np.int32)
    samp = rs.randint(0, 128, n).astype(np.int32)
    bounce = rs.randint(0, 16, n).astype(np.int32)

    def r(a):
        return a.reshape(a.shape[:-1] + shape)

    jv = {k: _vec_pair(r(v)) for k, v in
          (("o", origin), ("d", d), ("h", hit), ("n", nrm), ("c", ch))}
    jctx = jnodes.ShadeCtx(
        jv["o"][0], jv["d"][0], jnp.asarray(r(t)), jv["h"][0],
        jnp.asarray(r(inside)), jv["n"][0], jv["c"][0],
        jrng.RNGStream(7, r(px), r(py), r(samp), r(bounce)))
    tctx = tnodes.ShadeCtx(
        jv["o"][1], jv["d"][1], torch.from_numpy(r(t)), jv["h"][1],
        torch.from_numpy(r(inside)), jv["n"][1], jv["c"][1],
        trng.RNGStream(7, torch.from_numpy(r(px)), torch.from_numpy(r(py)),
                       torch.from_numpy(r(samp)), torch.from_numpy(r(bounce))))
    return jctx, tctx


def _const(v):
    """A material parameter in both packages (splat scalar or vec3)."""
    a = np.asarray(v, np.float32)
    return (jgraph._param_to_vec3(jnp.asarray(a)),
            tgraph._param_to_vec3(torch.from_numpy(a)))


def _flatten(out):
    """A node's outputs (a tuple of Vec3 or a ShaderOut) -> components."""
    return [c for v in out for c in v]


# (node, its inputs by name: parameters or the outputs of other nodes)
_C1, _C2 = [0.8, 0.3, 0.2], [0.1, 0.6, 0.9]
_NODES = [
    ("shader_diffuse", [_C1]),
    ("shader_glossy", [_C1, 0.3]),
    ("shader_refraction", [_C1, 1.45]),
    ("shader_refraction", [_C1, 1.45, [0.1, 0.2, 0.3]]),
    ("shader_volumeScatter", [_C1, 2.0]),
    ("shader_emission", [_C1, 8.0]),
    ("shader_mix", [_C1, [0, 0, 1], _C2, [1, 0, 0], 0.4]),
    ("shader_mix", [_C1, [0, 0, 1], 1.0, _C2, [1, 0, 0], 0.0, [0.2, 0.5, 0.8]]),
    ("misc_facing", []), ("misc_inside", []), ("misc_fresnel", []),
    ("math_add", [_C1, _C2]), ("math_subtract", [_C1, _C2]),
    ("math_multiply", [_C1, _C2]), ("math_divide", [_C1, _C2]),
    ("math_sine", [[0.3, 2.0, -4.0]]), ("math_cosine", [[0.3, 2.0, -4.0]]),
    ("shader_diffuse2", [_C1]), ("shader_glossy2", [_C1, 0.35]),
    ("shader_glossy2", [_C1, 0.0]), ("shader_mix2", None),
]


@pytest.mark.parametrize("channels", ["white", "one_hot"])
@pytest.mark.parametrize("node,args", _NODES,
                         ids=[f"{n}-{len(a) if a else 0}" for n, a in _NODES])
def test_material_node(node, args, channels):
    """Every material node on one ShadeCtx built from the same arrays,
    with white and one-hot (dispersion) channel masks; then the stream
    position must agree too (the node drew as many numbers)."""
    jctx, tctx = _ctx_pair(10 + len(node), channels=channels)
    fn_j = getattr(jnodes, node if node != "shader_volumeScatter"
                   else "shader_volume_scatter")
    fn_t = getattr(tnodes, node if node != "shader_volumeScatter"
                   else "shader_volume_scatter")
    if node == "shader_mix2":
        a_j, a_t = (jnodes.shader_diffuse2(jctx, _const(_C1)[0]),
                    tnodes.shader_diffuse2(tctx, _const(_C1)[1]))
        b_j, b_t = (jnodes.shader_glossy2(jctx, *(_const(v)[0]
                                                  for v in (_C2, 0.2))),
                    tnodes.shader_glossy2(tctx, *(_const(v)[1]
                                                  for v in (_C2, 0.2))))
        f = jnodes.misc_fresnel(jctx)[0], tnodes.misc_fresnel(tctx)[0]
        want = fn_j(jctx, a_j, b_j, f[0])
        got = fn_t(tctx, a_t, b_t, f[1])
    else:
        consts = [_const(v) for v in args]
        want = fn_j(jctx, *(c[0] for c in consts))
        got = fn_t(tctx, *(c[1] for c in consts))
    assert len(want) == len(got)
    for a, b in zip(_flatten(want), _flatten(got)):
        _close(b, a)
    np.testing.assert_array_equal(np.asarray(jctx.rng.next()),
                                  tctx.rng.next().numpy())


_FILES = sorted(glob.glob(os.path.join(_REPO, "data", "scenes", "*.scene")))
_SHADE_SCENES = ["sphere_on_floor", "single_sphere", "csg_demo", "cornell",
                 "glass_demo", "volume_demo", "all_materials",
                 "all_nodes"] + [os.path.basename(f) for f in _FILES]


def _scene_pair(name):
    if hasattr(tbuiltin, name):
        js, ts = getattr(jbuiltin, name)(), getattr(tbuiltin, name)()
    else:
        text = {"all_materials": ALL_MATERIALS_SCENE,
                "all_nodes": ALL_NODES_SCENE}.get(name)
        if text is None:
            with open(os.path.join(_REPO, "data", "scenes", name)) as f:
                text = f.read()
        js, ts = jgraph.loads_scene(text), tgraph.loads_scene(text)
    jp = js.init_params()
    return js, jp, ts, params_from_numpy(np_tree(jp), "cpu")


@pytest.mark.parametrize("name", _SHADE_SCENES)
def test_scene_shade(name):
    """`Scene.shade` with random material indices (-1 included):
    color, dir, inside and hit, and the stream position afterwards."""
    js, jp, ts, tp = _scene_pair(name)
    jctx, tctx = _ctx_pair(3, channels="white")
    rs = np.random.RandomState(4)
    mid = rs.randint(-1, len(js.materials), size=(32, 64)).astype(np.int32)
    want = js.shade(jp, jctx, jnp.asarray(mid))
    got = ts.shade(tp, tctx, torch.from_numpy(mid))
    for wv, gv in zip(want, got):
        for a, b in zip(wv, gv):
            assert tuple(b.shape) == (32, 64)
            _close(b, a)
    np.testing.assert_array_equal(np.asarray(jctx.rng.next()),
                                  tctx.rng.next().numpy())


class _CountingStream:
    """Counts the draws of a JAX material graph (the shading code only
    calls `next`)."""

    def __init__(self, inner):
        self.inner, self.n = inner, 0

    def next(self):
        self.n += 1
        return self.inner.next()


@pytest.mark.parametrize("name", _SHADE_SCENES)
def test_rng_bases_match_jax_draws(name):
    """The compiler's per-material RNG base is the stream slot of the
    material's first draw in the JAX package's `Scene.shade`, which runs
    every graph in order on one stream (gen-2: post-order of the walk from
    the output; unreachable nodes draw nothing)."""
    js, jp, ts, _ = _scene_pair(name)
    jctx, _ = _ctx_pair(5)
    counter = _CountingStream(jctx.rng)
    jctx.rng = counter
    want = []
    for i, mat in enumerate(js.materials):
        want.append(counter.n + 1)
        jgraph._eval_material(mat, jp["materials"][i], jctx)
    assert scene_program.rng_bases(ts) == want


def test_rng_bases_sphere_on_floor():
    """Emission draws nothing, so the floor starts at slot 1 and the
    ball, after the floor's two draws, at slot 3."""
    assert scene_program.rng_bases(tbuiltin.sphere_on_floor()) == [1, 1, 3]


def test_material_program_refuses_bad_graphs():
    text = ALL_MATERIALS_SCENE.replace('"inputs": ["s"], "outputs": ["co"]',
                                       '"inputs": ["zz"], "outputs": ["co"]')
    with pytest.raises(KeyError, match="read before it is written"):
        scene_program.rng_bases(tgraph.loads_scene(text))
