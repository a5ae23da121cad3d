"""Port parity, inverse rendering under an SH sky: the train step's loss
and gradients, the SH coefficients a leaf with a gradient (the replay
evaluates `Scene.sky` differentiably; the recorder reads no sky), against
the JAX package's gradient of the same loss on the same numpy inputs.

Bars: as in test_torch_train_env.py, the loss to rtol 1e-5 and every
leaf's gradient to atol 1e-4 * max|g| (measured: at most 3.4e-5, on the
ball's centre).
"""
import numpy as np
import torch

from _torch_env import assert_grads_close, jax_train_grads, port_train_grads
from _torch_parity import np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import graph as jgraph
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin
from raymarchrenderer_tpu_torch.scene import graph as tgraph
from raymarchrenderer_tpu_torch.scene import param_leaves, params_from_numpy


def _ball_json():
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.5, 0.4])
    b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    return b.to_json()


def test_sh_train_grads_match_jax():
    """An SH sky (random coefficients) over the ball, the recorded train
    gradients against the JAX package's; the sh leaf's gradient is
    non-zero, its DC term surely (tests/test_sh.py:82)."""
    sh = np.random.RandomState(6).uniform(0.0, 0.4, (16, 3)).astype(
        np.float32)
    js, ts = (mod.loads_scene(_ball_json(), env_sh=sh)
              for mod in (jgraph, tgraph))
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    kw = dict(width=24, height=16, max_steps=96, max_bounces=2,
              max_dist=100.0)
    jc = JCamera(aspect=1.5).corner_rays_flat()
    tc = torch.from_numpy(np.stack([np.asarray(c) for c in jc]))
    want = jax_train_grads(js, jp, JCfg(**kw), jc, 2)
    got = port_train_grads(ts, tp, TCfg(**kw), tc, 2, "recorded")
    assert_grads_close(want, got, [1e-4] * len(param_leaves(tp)))
    sh_leaf = got[1][[i for i, leaf in enumerate(param_leaves(tp))
                      if tuple(leaf.shape) == (16, 3)][0]]
    assert np.abs(sh_leaf[0]).max() > 0.0
