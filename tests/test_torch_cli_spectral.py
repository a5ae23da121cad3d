"""Port parity, the `train --spectral` verb: the port's CLI against the
JAX CLI for one step at a tiny size, and the other marches.

The JAX CLI runs its "oracle" march on the CPU (no `jax.grad` through an
interpret-mode kernel) over the 8-device CPU mesh of tests/conftest.py;
the port runs its default `--impl auto` (the spectral recorder) on one
device.  The fitted band rows must be equal (a sign step moves a row by a
whole 3 nm or 0.03 of power) and every fitted leaf within 1e-6 (lr 1e-2
times the gradient bar of tests/test_torch_spectral_diff.py).
"""
import numpy as np
import pytest
import torch

_FLAGS = ["--width", "32", "--height", "16", "--spp", "2", "--max-steps",
          "96", "--max-bounces", "3", "--steps", "1", "--lr", "1e-2"]
_KEYS = {"band_min_wave", "band_max_wave", "band_power"}


def _target(tmp_path):
    path = tmp_path / "target.npy"
    np.save(path, np.random.RandomState(9).uniform(
        0.0, 0.3, (16, 32, 3)).astype(np.float32))
    return str(path)


def test_train_spectral_matches_jax_cli(tmp_path, capsys):
    """Measured: every band row and every leaf equal."""
    from raymarchrenderer_tpu.app import cli as jcli
    from raymarchrenderer_tpu_torch.app import cli as tcli

    target = _target(tmp_path)
    jout, tout = tmp_path / "jax.npz", tmp_path / "torch.npz"
    assert jcli.main(["--no-cache", "train", "--spectral", "--cpu",
                      "--impl", "oracle", *_FLAGS, "--target", target,
                      "--out", str(jout)]) == 0
    loss, params, mats, (grads, band_grads), img = tcli.cmd_train(
        tcli.build_parser().parse_args(
            ["train", "--spectral", "--device", "cpu", *_FLAGS, "--target",
             target, "--out", str(tout)]))
    text = capsys.readouterr().out
    assert "training spectral 32x16 @ 2 spp, 1 steps (recorded, cpu)" in text
    assert (tmp_path / "torch.png").exists()
    assert img.shape == (16, 32, 3) and bool(torch.isfinite(img).all())
    assert all(float(g.abs().sum()) > 0.0 for g in band_grads)
    with np.load(jout) as jz, np.load(tout) as tz:
        assert set(tz.files) == set(jz.files)
        assert _KEYS <= set(tz.files)
        for k in _KEYS:
            np.testing.assert_array_equal(tz[k], jz[k])
        leaves = sorted(k for k in jz.files if k.startswith("leaf"))
        assert len(leaves) == 14
        for k in leaves:
            np.testing.assert_allclose(tz[k], jz[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mats.max_wave.numpy(),
                                  np.load(tout)["band_max_wave"])


@pytest.mark.parametrize("impl", ["fused", "oracle"])
def test_train_spectral_other_marches(tmp_path, impl):
    """`--impl fused` (march_fused per bounce; its plain version here) and
    `--impl oracle` take the same step as the recorded default: the same
    npz, to the leaf bar."""
    from raymarchrenderer_tpu_torch.app import cli as tcli

    target = _target(tmp_path)
    outs = {}
    for name in ("auto", impl):
        out = tmp_path / f"{name}.npz"
        loss, *_ = tcli.cmd_train(tcli.build_parser().parse_args(
            ["train", "--spectral", "--device", "cpu", "--impl", name,
             *_FLAGS, "--target", target, "--out", str(out)]))
        assert np.isfinite(float(loss))
        outs[name] = np.load(out)
    a, b = outs["auto"], outs[impl]
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6)
