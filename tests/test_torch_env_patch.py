"""Port parity, `render_fused_patch` under an env-image sky on the CPU:
the mega and wavefront routes' chunked launches (the mega bank depth of
32 paths with a tail launch for a prime spp, the wavefront depth of 8
with n_valid masking the last chunk) and their composites, against the
JAX package's oracle mean of `render_patch` (exact sky) on the same
numpy inputs.

Bars: the JAX package's env bars (tests/test_kernels.py:84-123,
255-278): atol 5e-3 against the oracle, fewer than 1e-3 of the values
off by more than 1e-3 for a multi-sample mean, by more than 5e-3 with
dispersion.  The mega route's 16-bit (u, v) quantisation is inside them:
at most 2.4e-4 texels of these 16-wide maps.
"""
import numpy as np
import pytest

from _torch_env import STRICT, case, jax_oracle
from _torch_parity import MAX_FRAC_OFF, frac_off

from raymarchrenderer_tpu_torch.kernels import march as tmarch


@pytest.mark.parametrize("mode,n,sample0", [("mega", 3, 2),
                                            ("wavefront", 3, 2),
                                            ("wavefront", 11, 0)],
                         ids=["mega", "wavefront", "wavefront-n_valid"])
def test_render_fused_patch_env_matches_jax_oracle(mode, n, sample0):
    """render_fused_patch on the CPU, the ball under the env map, a 16 x
    20 patch at origin (3, 2) of a 24 x 16 frame: the mean over `n`
    samples against the JAX oracle's (11 samples in wavefront mode: one
    chunk of 8 and a tail chunk with n_valid 3 of its 8 slots)."""
    js, jp, jcfg, jc, ts, tp, tcfg, tc = case("ball")
    want = jax_oracle(js, jp, jcfg, jc, (3, 2), (12, 20),
                      range(sample0, sample0 + n), False)
    got = tmarch.render_fused_patch(ts, tp, tcfg, tc, (3, 2), (12, 20),
                                    sample0, n_samples=n, mode=mode,
                                    **STRICT).numpy()
    assert frac_off(want, got, 1e-3) < MAX_FRAC_OFF
    np.testing.assert_allclose(got, want, atol=5e-3)


def test_render_fused_patch_env_prime_spp_tail():
    """37 samples (prime) in mega mode run a chunk of 32 paths and a tail
    launch of 5, on a 16 x 8 frame of the ball (2 bounces, 48 steps):
    equal to the JAX oracle's mean, and to the port's own launches summed
    by hand (the chunks cover every sample once)."""
    img = np.ones((4, 8, 3), np.float32) * 0.5
    img[:2] = 2.0
    js, jp, jcfg, jc, ts, tp, tcfg, tc = case("ball", w=16, h=8, img=img,
                                              max_bounces=2)
    jcfg = jcfg.replace(max_steps=48)
    tcfg = tcfg.replace(max_steps=48)
    want = jax_oracle(js, jp, jcfg, jc, (0, 0), (8, 16), range(37), False)
    calls = []
    launch = tmarch._mega_defer_plain

    def spy(*a, **kw):
        calls.append(a[8])
        return launch(*a, **kw)

    tmarch._mega_defer_plain = spy
    try:
        got = tmarch.render_fused_patch(ts, tp, tcfg, tc, (0, 0), (8, 16), 0,
                                        n_samples=37, **STRICT).numpy()
    finally:
        tmarch._mega_defer_plain = launch
    assert calls == [32, 5]
    assert frac_off(want, got, 1e-3) < MAX_FRAC_OFF


def test_render_fused_patch_env_dispersion_nee():
    """Dispersion and NEE under the env map, mega mode, 2 samples: the
    bank slots run over (sample, channel) paths; the JAX oracle's mean at
    the dispersion env bar (NEE adds float math, inside it)."""
    js, jp, jcfg, jc, ts, tp, tcfg, tc = case("nee", separate_channels=True)
    want = jax_oracle(js, jp, jcfg, jc, (0, 0), (16, 24), (1, 2), True)
    got = tmarch.render_fused_patch(ts, tp, tcfg, tc, (0, 0), (16, 24), 1,
                                    n_samples=2, direct_light=True,
                                    **STRICT).numpy()
    assert frac_off(want, got, 5e-3) < MAX_FRAC_OFF
