"""Port parity, inverse rendering under the env-image and SH skies: the
train step's loss and gradients (the recorder banks the geometry and
reads no sky; the replay evaluates `Scene.sky` differentiably, so the
env image and the SH coefficients are leaves with gradients), and a JAX
env scene's parameters carried into the port.

Bars: the loss to rtol 1e-5; every leaf, the sky's (the env image, the
SH coefficients) and the geometry's, to atol 1e-4 * max|g| of the leaf
(measured: at most 2.3e-5 * max|g|, on the ball's centre; 3.4e-5 under
the SH sky).  Images at the JAX package's env bar (fewer than 1e-3 of
the values off by more than 1e-3, atol 5e-3).  The SH sky's train step
is in test_torch_train_sh.py.
"""
import jax
import numpy as np
import torch

from _torch_env import (assert_grads_close, case, jax_oracle,
                        jax_train_grads, port_train_grads)
from _torch_parity import MAX_FRAC_OFF, frac_off, np_tree

from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.scene import (param_leaves, params_from_numpy,
                                              params_replace, params_to_numpy)


def test_env_train_grads_match_jax():
    """The ball under the env map, 24 x 16, 2 samples, 2 bounces: the
    port's train_grads_sharded (the recorder's plain version, then the
    replay) against the JAX package's gradient of the same loss.  The env
    image's gradient and an object leaf's (through the hit point, the
    normal, the miss direction and the sky) are non-zero."""
    js, jp, jcfg, jc, ts, tp, tcfg, tc = case("ball", max_bounces=2)
    want = jax_train_grads(js, jp, jcfg, jc, 2)
    got = port_train_grads(ts, tp, tcfg, tc, 2, "recorded")
    assert_grads_close(want, got, [1e-4] * len(param_leaves(tp)))
    grads = params_replace(tp, [torch.from_numpy(g) for g in got[1]])
    assert float(grads["env"]["image"].abs().max()) > 0.0
    assert max(float(g.abs().max()) for g in param_leaves(
        grads["objects"])) > 0.0


def test_jax_env_params_carry_into_the_port():
    """A JAX env scene's parameters, edited on the JAX side (the env image
    and the ball's radius), carried into the port with params_from_numpy:
    the port's leaves come back from params_to_numpy in JAX leaf order,
    and its render (mega route, 3 samples) matches the JAX oracle's render
    of the same parameters at the env bar."""
    js, jp, jcfg, jc, ts, tp0, tcfg, tc = case("ball")
    jnew = jax.tree.map(lambda x: x, jp)
    jnew["env"]["image"] = jp["env"]["image"][:, ::-1] * 1.5
    jnew["objects"][0][1] = jp["objects"][0][1] * 0.9
    leaves = [np.asarray(a) for a in jax.tree.leaves(jnew)]
    tp = params_from_numpy(np_tree(jnew), "cpu")
    for a, b in zip(leaves, params_to_numpy(tp)):
        np.testing.assert_array_equal(a, b)
    want = jax_oracle(js, jnew, jcfg, jc, (0, 0), (16, 24), (0, 1, 2), False)
    got = tmarch.render_fused(ts, tp, tcfg, tc, 0, n_samples=3,
                              lazy_miss=False, march_unroll=4,
                              regen_cadence=0).numpy()
    assert frac_off(want, got, 1e-3) < MAX_FRAC_OFF
    np.testing.assert_allclose(got, want, atol=5e-3)
