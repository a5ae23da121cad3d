"""Port parity, scenes: parsing, parameters, band tables, `map`,
`map_dist` and SDF normals against the JAX package.

Parsing is the same Python over the same JSON, so parameter leaves and
band tables are bitwise equal.  Distances agree to 1e-5 at seeded random
points; they are bitwise equal for the repo's scene files (sphere, box,
subtract, repeat), and the all-nodes scene adds `map_plane` (1/sqrt vs
rsqrt of its normal) and sin/cos (1 ulp apart).
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ALL_NODES_SCENE, np_tree

from raymarchrenderer_tpu.render import integrator as jint
from raymarchrenderer_tpu.render import spectral_integrator as jspec
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu.core.vecmath import Vec3 as JVec3
from raymarchrenderer_tpu_torch.core.vecmath import Vec3 as TVec3
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FILES = sorted(glob.glob(os.path.join(_REPO, "data", "scenes", "*.scene")))
_SCENES = [os.path.basename(f) for f in _FILES] + ["all_nodes", "demo"]


def _texts(name):
    if name == "all_nodes":
        return ALL_NODES_SCENE
    with open(os.path.join(_REPO, "data", "scenes", name)) as f:
        return f.read()


def _pair(name):
    """(jax scene, jax params, torch scene, torch params)."""
    if name == "demo":
        js, jp, _ = jspec.spectral_demo()
        ts, tp, _ = tspec.spectral_demo("cpu")
        return js, jp, ts, tp
    text = _texts(name)
    js, ts = jgraph.loads_scene(text), tgraph.loads_scene(text)
    return js, js.init_params(), ts, ts.init_params("cpu")


def _flat(tree, prefix=""):
    """{path: leaf} over the nested dict/list parameter structure."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


def test_scene_files_present():
    assert len(_FILES) >= 7


@pytest.mark.parametrize("name", _SCENES)
def test_params_and_band_table_bitwise(name):
    js, jp, ts, tp = _pair(name)
    assert len(ts.objects) == len(js.objects)
    assert len(ts.materials) == len(js.materials)
    assert ts.spectral_rows == js.spectral_rows
    assert [ts.mat_index(o.mat_id) for o in ts.objects] == \
        [js.mat_index(o.mat_id) for o in js.objects]
    want, got = _flat(jp), _flat({k: v for k, v in tp.items()})
    assert sorted(want) == sorted(got)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    # the converter takes the JAX pytree as numpy and gives the same dict
    conv = _flat(params_from_numpy(np_tree(jp), "cpu"))
    for path, leaf in want.items():
        np.testing.assert_array_equal(conv[path], leaf, err_msg=path)
    for jm, tm in zip(jspec.band_table(js), tspec.band_table(ts, "cpu")):
        assert tm.dtype == (torch.int32 if jm.dtype == jnp.int32
                            else torch.float32)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_default_band_table_bitwise():
    text = _texts("default.scene")
    js, ts = jgraph.loads_scene(text), tgraph.loads_scene(text)
    for jm, tm in zip(jspec.default_band_table(js),
                      tspec.default_band_table(ts, "cpu")):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _points(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-4.0, 4.0, size=(3, n)).astype(np.float32)
    pts[1] = rs.uniform(-0.5, 3.0, size=n).astype(np.float32)
    return pts


@pytest.mark.parametrize("name", _SCENES)
def test_map_and_map_dist(name):
    js, jp, ts, tp = _pair(name)
    pts = _points()
    jd, jmid = js.map(jp, JVec3(*(jnp.asarray(c) for c in pts)), 100.0)
    td, tmid = ts.map(tp, TVec3(*(torch.from_numpy(c) for c in pts)), 100.0)
    np.testing.assert_array_equal(tmid.numpy(), np.asarray(jmid))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    jdd = js.map_dist(jp, JVec3(*(jnp.asarray(c) for c in pts)), 100.0)
    tdd = ts.map_dist(tp, TVec3(*(torch.from_numpy(c) for c in pts)), 100.0)
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("taps", [4, 6, 0])
@pytest.mark.parametrize("name", ["spectral.scene", "object_test.scene",
                                  "default.scene", "all_nodes"])
def test_get_normal(name, taps):
    """At points within 0.5 of a surface, every component within 1.5e-4
    (measured: at most 6e-5).  XLA:CPU's f32 sqrt is 1 ulp off the
    correctly rounded one (which torch, numpy and the CUDA kernel give) in
    about 0.5% of inputs, and its sin/cos and rsqrt differ too, so a tap's
    distance can differ by up to 1.2e-7.  The stencil's unnormalised
    normal has length 2*eps (6 taps) or 4*eps (4 taps) with eps = 1e-3,
    and sums 2 or 4 taps per component: 2-4 x 1.2e-7 / (2-4e-3) bounds
    the difference of the normalised normal by 1.2e-4.  The exact
    gradient (0 taps) has no such division: measured 1.8e-7; it is NaN
    where JAX's is (inside the all-nodes scene's cylinder), compared as
    NaN."""
    js, jp, ts, tp = _pair(name)
    pts = _points(8192, seed=1)
    jcfg = JCfg(normal_taps=taps, max_dist=100.0)
    tcfg = TCfg(normal_taps=taps, max_dist=100.0)
    near = np.abs(np.asarray(js.map_dist(
        jp, JVec3(*(jnp.asarray(c) for c in pts)), 100.0))) < 0.5
    pts = pts[:, near]
    assert pts.shape[1] > 200
    jn = jint.get_normal(js, jp, jcfg, JVec3(*(jnp.asarray(c) for c in pts)))
    tn = tint.get_normal(ts, tp, tcfg,
                         TVec3(*(torch.from_numpy(c) for c in pts)))
    want = np.stack([np.asarray(a) for a in jn])
    got = np.stack([b.numpy() for b in tn])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert float(np.nanmax(np.abs(got - want))) <= 1.5e-4


def test_get_normal_exact_gradient_not_ported():
    """The exact gradient (`normal_taps=0`) is ported: on simple.scene's
    unit sphere at (0, 1, 0) the normal at p is (p - centre) / |p -
    centre|, to an ulp."""
    ts = tgraph.loads_scene(_texts("simple.scene"))
    pts = np.float32([[2.0, 0.0, 0.0, -0.3], [1.0, 3.0, -1.0, 1.2],
                      [0.0, 0.0, 0.0, 0.9]])
    p = TVec3(*(torch.from_numpy(c) for c in pts))
    n = tint.get_normal(ts, ts.init_params("cpu"), TCfg(normal_taps=0), p)
    q = pts - np.float32([[0.0], [1.0], [0.0]])
    want = q / np.linalg.norm(q, axis=0)
    np.testing.assert_allclose(np.stack([c.numpy() for c in n]), want,
                               rtol=0, atol=2e-7)
