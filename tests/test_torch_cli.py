"""Port parity, the CLI: `render --spectral` end to end, the import
boundary, and the device rule.

The JAX CLI on the CPU renders the spectral path with its oracle
(`app/cli.py` picks "oracle" off the TPU; its fused kernel needs a TPU),
and the megakernel schedule equals that oracle to 1e-6
(tests/test_mega.py).  Both CLIs run the strict knobs (relax 0, 6 normal
taps, the defaults); the PNGs are compared after decoding, with the JAX
package's image bar: fewer than 1e-3 of the values off by more than 1e-5.
"""
import os
import subprocess
import sys

import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, frac_off

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLAGS = ["--width", "32", "--height", "32", "--spp", "2", "--chunk", "2",
          "--max-steps", "192", "--max-bounces", "4"]


def test_render_spectral_matches_jax_cli(tmp_path, capsys):
    from raymarchrenderer_tpu.app import cli as jcli
    from raymarchrenderer_tpu.io.image import load_png
    from raymarchrenderer_tpu_torch.app import cli as tcli

    jout, tout = tmp_path / "jax.png", tmp_path / "torch.png"
    assert jcli.main(["--no-cache", "render", "--spectral", "--cpu",
                      "--impl", "oracle", *_FLAGS, "--out", str(jout)]) == 0
    assert tcli.main(["render", "--spectral", "--device", "cpu", *_FLAGS,
                      "--out", str(tout)]) == 0
    text = capsys.readouterr().out
    assert "2/2 spp" in text and "Mpix*spp/s" in text
    want, got = load_png(str(jout)), load_png(str(tout))
    assert got.shape == (32, 32, 3) and got.max() > 0.0
    assert frac_off(want, got) < MAX_FRAC_OFF          # measured 0.0


def test_cmd_render_returns_the_image(tmp_path):
    from raymarchrenderer_tpu_torch.app import cli as tcli
    args = tcli.build_parser().parse_args(
        ["render", "--spectral", "--device", "cpu", "--scene",
         os.path.join(_REPO, "data", "scenes", "spectral.scene"),
         "--width", "16", "--height", "8", "--spp", "1", "--max-steps", "64",
         "--max-bounces", "2", "--relax", "2.0", "--normal-taps", "4",
         "--out", str(tmp_path / "o.npy")])
    img, n, seconds = tcli.cmd_render(args)
    assert n == 1.0 and seconds > 0.0
    assert img.shape == (8, 16, 3) and bool(torch.isfinite(img).all())
    assert (tmp_path / "o.npy").exists()


def test_render_needs_spectral(tmp_path):
    from raymarchrenderer_tpu_torch.app import cli as tcli
    with pytest.raises(SystemExit, match="spectral"):
        tcli.main(["render", "--device", "cpu", "--out",
                   str(tmp_path / "x.png")])


def test_cuda_device_without_a_card_fails(tmp_path):
    """`--device cuda` never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from raymarchrenderer_tpu_torch.app import cli as tcli
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["render", "--spectral", "--width", "8", "--height", "8",
                   "--out", str(tmp_path / "x.png")])


def test_port_imports_no_jax():
    code = ("import sys, raymarchrenderer_tpu_torch, "
            "raymarchrenderer_tpu_torch.app.cli, "
            "raymarchrenderer_tpu_torch.kernels.march, "
            "raymarchrenderer_tpu_torch.render.mega; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('raymarchrenderer_tpu.') "
            "or m == 'raymarchrenderer_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
