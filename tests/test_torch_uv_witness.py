"""Witness for the bars on the deferred sky's packed (u, v) banks: how far
one ulp of libm moves them, inside the port alone.

The deferred sky banks a missed path's direction as two 16-bit bins,
(u << 16) | v.  The pack of the same directions is held to the tight bar,
equal on all but 1e-3 of them and never more than one bin apart
(test_torch_env_render.py::test_pack_uv_matches_jax).  The banks of a
whole render are held to looser bars: the JAX package against the port
on the CPU, all but 5% of the live slots and at most 4 bins
(test_torch_env_render.py); the deferred-sky kernel against its plain
version on the card, all but 2% and at most 16 bins
(test_torch_cuda.py::test_defer_kernel_matches_plain).  Both compare
implementations whose sin, cos and sqrt differ by an ulp, and a miss
direction after a few bounces carries that ulp through the
finite-difference normals and the sampled bounce directions.

Here the port's plain version is run twice on the same inputs, the
second time with `torch.sin` and `torch.cos` (and, for the CPU tests'
scenes, `torch.sqrt`, which XLA:CPU does not round correctly) one ulp up
on the inputs whose lowest mantissa bit is set.  The paths stay the same
paths: every throughput bank is equal.  The packed banks move past the
tight bar all the same.  `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_uv_witness.py` prints these readings (the fraction of
the live slots off, the largest bin distance) and, on the CPU tests'
scenes, the JAX package's against the port's.
"""
import numpy as np
import pytest
import torch

from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.render import mega as tmega
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.scene import builtin

_DISP = dict(separate_channels=True, rr_start_bounce=1)
STRICT = dict(lazy_miss=False, march_unroll=4, regen_cadence=0)
PRODUCTION = dict(lazy_miss=True, march_unroll=32, regen_cadence=16)

# name: (scene kind, direct light, config extras, env image (h, w),
#        frame (w, h), patch origin, patch (h, w), sample0, samples,
#        schedule, functions moved by an ulp)
CASES = {
    # the scenes and knobs of test_torch_env_render.py (24 x 16)
    "cpu-glass": ("glass", False, {}, (8, 16), (24, 16), (0, 0), (16, 24),
                  1, 2, PRODUCTION, ("sin", "cos", "sqrt")),
    "cpu-nee": ("nee", True, {}, (8, 16), (24, 16), (0, 0), (16, 24), 1, 2,
                STRICT, ("sin", "cos", "sqrt")),
    "cpu-dispersion-rr": ("glass", False, _DISP, (8, 16), (24, 16), (0, 0),
                          (16, 24), 1, 1, STRICT, ("sin", "cos", "sqrt")),
    # the scenes and knobs of test_torch_cuda.py's deferred-sky test
    "card-glass": ("glass", False, {}, (16, 32), (96, 64), (8, 4), (48, 80),
                   2, 3, PRODUCTION, ("sin", "cos")),
    "card-nee": ("nee", True, {}, (16, 32), (96, 64), (8, 4), (48, 80), 2, 3,
                 PRODUCTION, ("sin", "cos")),
    "card-dispersion-rr": ("glass", False, _DISP, (16, 32), (96, 64), (8, 4),
                           (48, 80), 2, 3, PRODUCTION, ("sin", "cos")),
}


def _scene(kind, img_shape):
    img = np.random.RandomState(7).uniform(0.0, 2.0, (*img_shape, 3)).astype(
        np.float32)
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.5, 0.4])
    if kind == "glass":
        b.sphere(b.glass([0.9, 0.95, 1.0], ior=1.45), [0.0, 1.0, 0.0], 1.0)
    else:
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    if kind == "nee":
        b.light([3, 7, -3], 60.0, 0.8)
    return b.build(env_image=img)


def _one_ulp_up(fn):
    """fn, with its float32 results one ulp up where the input's lowest
    mantissa bit is set."""
    def moved(x, *args, **kw):
        y = fn(x, *args, **kw)
        if x.dtype != torch.float32:
            return y
        odd = (x.view(torch.int32) & 1) == 1
        return torch.where(odd, torch.nextafter(y, torch.full_like(
            y, float("inf"))), y)
    return moved


def banks(name, moved=()):
    """The deferred megakernel schedule's banks (thr_r, thr_g, thr_b,
    packed uv) of case `name`, with the functions `moved` one ulp up."""
    (kind, nee, extra, img, (w, h), origin, shape, s0, n, knobs,
     _) = CASES[name]
    scene = _scene(kind, img)
    if name.startswith("card"):
        cfg = RenderConfig(width=w, height=h, max_steps=192, max_bounces=4,
                           max_dist=100.0, relax_omega=2.0, normal_taps=4,
                           **extra)
        cam = dict(eye=(0.0, 3.0, -7.0))
    else:
        cfg = RenderConfig(width=w, height=h, max_steps=96, max_bounces=3,
                           max_dist=100.0, **extra)
        cam = {}
    corners = Camera(aspect=w / h, **cam).corner_rays_flat("cpu")
    return trace_banks(scene, scene.init_params("cpu"), cfg, corners, origin,
                       shape, s0, n, nee, knobs, moved)


def trace_banks(scene, params, cfg, corners, origin, shape, s0, n, nee,
                knobs, moved=()):
    px, py = pixel_grid(shape[1], shape[0], "cpu", origin)
    saved = {f: getattr(torch, f) for f in moved}
    try:
        for f in moved:
            setattr(torch, f, _one_ulp_up(saved[f]))
        _, out = tmega.trace_mega_paths(
            scene, params, cfg, corners, px, py, s0, n_samples=n,
            dispersion=cfg.separate_channels, direct_light=nee,
            defer_sky=True, **knobs)
    finally:
        for f, fn in saved.items():
            setattr(torch, f, fn)
    return [b.numpy() for b in out]


def uv_spread(want, got):
    """(fraction of the live slots whose packed (u, v) differ, largest bin
    distance), live = thr > 0 in `want`."""
    live = want[0] + want[1] + want[2] > 0
    du = np.abs((want[3] >> 16) - (got[3] >> 16))
    dv = np.abs((want[3] & 0xFFFF) - (got[3] & 0xFFFF))
    return (float(((du > 0) | (dv > 0))[live].mean()),
            int(np.maximum(du, dv)[live].max(initial=0)))


@pytest.mark.parametrize("name", list(CASES))
def test_one_ulp_moves_the_packed_banks(name):
    """The same paths (every throughput bank equal), yet the packed (u, v)
    banks past the tight bar: more than 1e-3 of the live slots off, or
    more than one bin apart; on the card test's scenes within the card
    test's bar (2%, 16 bins)."""
    want = banks(name)
    got = banks(name, CASES[name][-1])
    for j in range(3):
        np.testing.assert_array_equal(got[j], want[j])
    frac, bins = uv_spread(want, got)
    assert frac > 1e-3 or bins > 1, (frac, bins)
    if name.startswith("card"):
        assert frac < 2e-2 and bins <= 16, (frac, bins)


if __name__ == "__main__":
    from _torch_env import case as jax_case
    from test_torch_env_render import _jax_mega
    torch.set_num_threads(1)
    for name, c in CASES.items():
        frac, bins = uv_spread(banks(name), banks(name, c[-1]))
        line = (f"{name}: {'/'.join(c[-1])} one ulp up: (u, v) off on "
                f"{frac:.4%} of the live slots, largest {bins} bin(s)")
        if name.startswith("cpu"):
            # test_torch_env_render.py's comparison on the same inputs
            kind, nee, extra, _, _, origin, shape, s0, n, knobs, _ = c
            js, jp, jcfg, jc, ts, tp, tcfg, tc = jax_case(kind, **extra)
            frac, bins = uv_spread(
                _jax_mega(js, jp, jcfg, jc, shape, s0, n, bool(extra), nee,
                          knobs)[1],
                trace_banks(ts, tp, tcfg, tc, origin, shape, s0, n, nee,
                            knobs))
            line += (f"; the JAX package against the port: {frac:.4%}, "
                     f"{bins} bin(s)")
        print(line, flush=True)
