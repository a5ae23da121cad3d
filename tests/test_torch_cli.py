"""Port parity, the CLI: `render` (RGB, with and without
`--direct-light`) and `render --spectral` end to end, the import boundary,
and the device rule.

The JAX CLI on the CPU renders with its oracle (`app/cli.py` picks
"oracle" off the TPU; its fused kernel needs a TPU), and the megakernel
schedules equal that oracle (tests/test_mega.py: bitwise for RGB without
NEE, to 1e-6 for spectral, to the NEE bar with NEE).  Both CLIs run the
strict knobs (relax 0, 6 normal taps, the defaults).  The spectral PNGs
are compared after decoding and the RGB images as .npy (linear floats),
with the JAX package's image bar: fewer than 1e-3 of the values off by
more than 1e-5; with NEE, its NEE bar.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, assert_nee_close, frac_off

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
    assert tcli.main(["render", "--spectral", "--device", "cpu", "--impl",
                      "fused", *_FLAGS, "--out", str(tout)]) == 0
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


@pytest.mark.parametrize("path", [["--spectral"], []],
                         ids=["spectral", "rgb"])
def test_render_layout_splits_the_frames(tmp_path, capsys, path):
    """`--layout 1x2` on the CPU (two virtual positions, each launch of
    `--chunk` samples one sharded frame at its sample0) against the
    one-device path, within the spp split's drift
    (tests/test_torch_parallel.py: fewer than 1% of the values off by
    more than 1e-5, none by 1e-2; measured: equal)."""
    from raymarchrenderer_tpu_torch.app import cli as tcli
    flags = ["render", *path, "--device", "cpu", "--impl", "fused",
             "--width", "16", "--height", "16", "--spp", "4", "--chunk", "2",
             "--max-steps", "128", "--max-bounces", "2"]
    one, split = tmp_path / "one.npy", tmp_path / "split.npy"
    assert tcli.main([*flags, "--out", str(one)]) == 0
    assert tcli.main([*flags, "--layout", "1x2", "--out", str(split)]) == 0
    assert "layout 1x2" in capsys.readouterr().out
    d = np.abs(np.load(one) - np.load(split))
    assert float((d > 1e-5).mean()) < 1e-2 and float(d.max()) < 1e-2
    assert np.load(split).max() > 0.0


@pytest.mark.parametrize("layout,impl,message", [
    ("2by2", "fused", "expected TILExSPP"),
    ("0x2", "fused", "tile and spp must be >= 1"),
    ("1x2", "oracle", "use --impl fused")])
def test_render_layout_refuses(tmp_path, layout, impl, message):
    from raymarchrenderer_tpu_torch.app import cli as tcli
    with pytest.raises(SystemExit, match=message):
        tcli.main(["render", "--spectral", "--device", "cpu", "--impl",
                   impl, "--width", "8", "--height", "8", "--layout", layout,
                   "--out", str(tmp_path / "x.npy")])


@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_render_rgb_matches_jax_cli(tmp_path, capsys, nee):
    """`render` without --spectral: sphere_on_floor, and csg with
    --direct-light (measured: 0 values off plain; with NEE none off by
    more than 1e-3)."""
    from raymarchrenderer_tpu.app import cli as jcli
    from raymarchrenderer_tpu_torch.app import cli as tcli

    extra = ["--scene", "csg", "--direct-light"] if nee else []
    jout, tout = tmp_path / "jax.npy", tmp_path / "torch.npy"
    assert jcli.main(["--no-cache", "render", "--cpu", "--impl", "oracle",
                      *_FLAGS, *extra, "--out", str(jout)]) == 0
    assert tcli.main(["render", "--device", "cpu", "--impl", "fused",
                      *_FLAGS, *extra, "--out", str(tout)]) == 0
    text = capsys.readouterr().out
    assert "(rgb, cpu)" in text and "2/2 spp" in text
    want, got = np.load(jout), np.load(tout)
    assert got.shape == (32, 32, 3) and got.mean() > 0.01
    if nee:
        assert_nee_close(want, got)
    else:
        assert frac_off(want, got) < MAX_FRAC_OFF


def test_render_needs_spectral(tmp_path):
    """The RGB path no longer needs `--spectral`, and it renders an SH sky
    (a scene with nothing in it shows the sky itself), with every normal
    estimator: `--normal-taps 0` (the exact normal) renders too, through
    the fused path and the oracle."""
    from raymarchrenderer_tpu_torch.app import cli as tcli
    scene = tmp_path / "sh.scene"
    scene.write_text('{"materials": [], "objects": [], "environment": '
                     '{"sh": ' + str([[0.1, 0.2, 0.3]] * 16) + '}}')
    out = tmp_path / "x.npy"
    assert tcli.main(["render", "--device", "cpu", "--scene", str(scene),
                      "--width", "8", "--height", "8", "--spp", "1",
                      "--out", str(out)]) == 0
    img = np.load(out)
    assert np.isfinite(img).all() and img.mean() > 0.0
    for impl in ("fused", "oracle"):
        out = tmp_path / f"y_{impl}.npy"
        assert tcli.main(["render", "--device", "cpu", "--scene",
                          str(scene), "--width", "8", "--height", "8",
                          "--spp", "1", "--normal-taps", "0", "--impl", impl,
                          "--out", str(out)]) == 0
        np.testing.assert_array_equal(np.load(out), img)


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
            "raymarchrenderer_tpu_torch.kernels.record, "
            "raymarchrenderer_tpu_torch.kernels.scene_program, "
            "raymarchrenderer_tpu_torch.diff.march, "
            "raymarchrenderer_tpu_torch.parallel, "
            "raymarchrenderer_tpu_torch.parallel.sharding, "
            "raymarchrenderer_tpu_torch.parallel.multihost, "
            "raymarchrenderer_tpu_torch.parallel.recovery, "
            "raymarchrenderer_tpu_torch.render.integrator, "
            "raymarchrenderer_tpu_torch.io.image, "
            "raymarchrenderer_tpu_torch.render.mega, "
            "raymarchrenderer_tpu_torch.render.spectral_integrator, "
            "raymarchrenderer_tpu_torch.scene.nodes, "
            "raymarchrenderer_tpu_torch.scene.graph, "
            "raymarchrenderer_tpu_torch.core.sampling, "
            "raymarchrenderer_tpu_torch.io.checkpoint, "
            "raymarchrenderer_tpu_torch.io.hdr, "
            "raymarchrenderer_tpu_torch.io.native_bindings, "
            "raymarchrenderer_tpu_torch.render.scheduler_native, "
            "raymarchrenderer_tpu_torch.render.tiles, "
            "raymarchrenderer_tpu_torch.utils, "
            "raymarchrenderer_tpu_torch.utils.metrics, "
            "raymarchrenderer_tpu_torch.utils.parity, "
            "raymarchrenderer_tpu_torch.utils.profiling, "
            "raymarchrenderer_tpu_torch.utils.guards, "
            "raymarchrenderer_tpu_torch.app.viewer, "
            "raymarchrenderer_tpu_torch.app.bench, "
            "raymarchrenderer_tpu_torch.core, "
            "raymarchrenderer_tpu_torch.core.color; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('raymarchrenderer_tpu.') "
            "or m == 'raymarchrenderer_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
