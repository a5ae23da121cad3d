"""Port parity, the recorder's folded layouts: `kernels.record`
`trace_record_fused` (CPU route: the plain recording schedule) against
the JAX package's `trace_record_fused(mode="mega")` in Pallas interpret
mode, and `fold_banks` with dispersion and NEE against the JAX package's
reshapes (`kernels/record.py:405-431`) on seeded banks.  Bars as in
tests/test_torch_record.py.
"""
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_banked_t_close, corners_to_torch, np_tree
from _torch_paths import scene_pair

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.kernels.record import (
    trace_record_fused as jrecord)
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.kernels.record import (fold_banks,
                                                       trace_record_fused)
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import params_from_numpy

_S, _B = 2, 3


def test_trace_record_fused_layout():
    """The wrapper's folded banks, on CPU tensors (the plain version at
    unroll 1, strict), against the JAX Pallas recorder in interpret mode
    (unroll 1), csg_demo with NEE on an 8 x 32 patch at (8, 4):
    (B, S*H, W), sd (B*L, S*H, W)."""
    cfg = dict(width=48, height=24, max_steps=96, max_bounces=_B,
               max_dist=100.0)
    js, ts = scene_pair("csg_demo")
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    corners = JCamera(aspect=2.0).corner_rays_flat()
    ox, oy, ph, pw = 8, 4, 8, 32
    py2 = jnp.broadcast_to(jnp.arange(ph, dtype=jnp.int32)[:, None] + oy,
                           (ph, pw))
    px2 = jnp.broadcast_to(jnp.arange(pw, dtype=jnp.int32)[None, :] + ox,
                           (ph, pw))
    want = jrecord(js, jp, JCfg(**cfg), None, None, px2, py2, jnp.uint32(0),
                   direct_light=True, block=(8, 32), interpret=True,
                   corners=corners, mode="mega", n_samples=_S)
    launches = tmarch.RECORD_PATHS.launches
    got = trace_record_fused(ts, tp, TCfg(**cfg), corners_to_torch(corners),
                             (ox, oy), (ph, pw), 0, n_samples=_S,
                             direct_light=True)
    assert tmarch.RECORD_PATHS.launches == launches     # CPU: no kernel
    assert set(got) == set(want) == {"t", "mid", "hit", "sd"}
    assert got["t"].shape == (_B, _S * ph, pw)
    assert got["sd"].shape == (_B * 1, _S * ph, pw)
    assert_banked_t_close(np.asarray(want["t"]), got["t"].numpy(), 1)
    for k in ("mid", "hit", "sd"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_fold_banks_dispersion_nee():
    """Slot b*3S + 3s + ci -> (3, B, S*H, W); sd slot (b*3S + 3s + ci)*L
    + li -> (3, B*L, S*H, W): the JAX package's reshapes, in numpy."""
    B, S, L, h, w = 3, 2, 2, 4, 5
    rng = np.random.RandomState(1)
    t = rng.rand(B * 3 * S, h, w).astype(np.float32)
    mid = rng.randint(-1, 4, (B * 3 * S, h, w)).astype(np.int32)
    hit = (mid >= 0).astype(np.int32)
    sd = rng.rand(B * 3 * S * L, h, w).astype(np.float32)
    got = fold_banks(tuple(map(torch.from_numpy, (t, mid, hit, sd))), B, S,
                     h, w, dispersion=True)

    def fold(a):
        return a.reshape(B, S, 3, h, w).transpose(2, 0, 1, 3, 4).reshape(
            3, B, S * h, w)

    for k, a in (("t", t), ("mid", mid), ("hit", hit)):
        np.testing.assert_array_equal(got[k].numpy(), fold(a))
    np.testing.assert_array_equal(
        got["sd"].numpy(), sd.reshape(B, S, 3, L, h, w).transpose(
            2, 0, 3, 1, 4, 5).reshape(3, B * L, S * h, w))
