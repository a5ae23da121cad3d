"""Port parity, the CLI under env-image and SH skies: `render --env-map`
and an SH scene file against the JAX CLI's render (its oracle on the
CPU), `--env-map` with a builtin scene name (dropped, as in the JAX CLI),
and `train --env-map` end to end.

Bars: 99% of the values within 1e-4 (the mega route's 16-bit (u, v)
quantisation and the miss directions' ulp noise are inside it), and
fewer than 1e-2 of them off by more than 1e-3: at 24 x 16, 2 samples,
default.scene has 2 of its 384 pixels on a path that flips between the
packages (XLA:CPU's ulp-off transcendentals), under the constant sky as
under these, measured on the same pixels; the JAX package's env bar
(fewer than 1e-3 off by more than 1e-3, tests/test_kernels.py:109-123)
counts its own kernel against its own oracle, with no such flip.  The
builtin with and without `--env-map` bitwise.
"""
import json
import os

import numpy as np
import torch

from _torch_parity import frac_off

from raymarchrenderer_tpu.app import cli as jcli
from raymarchrenderer_tpu_torch.app import cli as tcli
from raymarchrenderer_tpu_torch.io import save_hdr

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCENE = os.path.join(_REPO, "data", "scenes", "default.scene")
_FLAGS = ["--width", "24", "--height", "16", "--spp", "2", "--chunk", "2",
          "--max-steps", "96", "--max-bounces", "3"]


def _sky(path):
    """A 16 x 32 gradient sky (the shape of bench.py's env map), saved
    with the port's save_hdr."""
    yy = np.linspace(0.0, 1.0, 16, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, 32, dtype=np.float32)[None, :]
    img = np.stack([0.3 + 0.7 * (1 - yy) + 0 * xx, 0.4 + 0.3 * xx + 0 * yy,
                    0.6 + 0.4 * (1 - yy) * xx], -1).astype(np.float32)
    save_hdr(str(path), img)
    return str(path)


def assert_cli_close(want, got):
    d = np.abs(want - got)
    assert float(np.quantile(d, 0.99)) < 1e-4
    assert frac_off(want, got, 1e-3) < 1e-2


def _both(tmp_path, scene_flags):
    jout, tout = tmp_path / "jax.npy", tmp_path / "torch.npy"
    assert jcli.main(["--no-cache", "render", "--cpu", "--impl", "oracle",
                      *scene_flags, *_FLAGS, "--out", str(jout)]) == 0
    assert tcli.main(["render", "--device", "cpu", "--impl", "fused",
                      *scene_flags, *_FLAGS, "--out", str(tout)]) == 0
    return np.load(jout), np.load(tout)


def test_render_env_map_matches_jax_cli(tmp_path, capsys):
    """render --env-map on default.scene: the port's deferred sky (mega
    route, one chunk of 2 paths and its composite) against the JAX
    CLI's oracle render."""
    sky = _sky(tmp_path / "sky.hdr")
    want, got = _both(tmp_path, ["--scene", _SCENE, "--env-map", sky])
    assert "rgb, env map" in capsys.readouterr().out
    assert got.shape == (16, 24, 3) and got.mean() > 0.0
    assert_cli_close(want, got)


def test_render_sh_scene_matches_jax_cli(tmp_path):
    """A scene file whose `environment` holds an `sh` array renders with
    that SH sky in both CLIs."""
    with open(_SCENE) as f:
        doc = json.load(f)
    sh = np.random.RandomState(4).uniform(0.0, 0.3, (16, 3))
    doc.setdefault("environment", {})["sh"] = sh.tolist()
    path = tmp_path / "sh.scene"
    path.write_text(json.dumps(doc))
    want, got = _both(tmp_path, ["--scene", str(path)])
    assert got.mean() > 0.0
    assert_cli_close(want, got)


def test_env_map_with_a_builtin_is_dropped(tmp_path):
    """As in the JAX CLI, only a scene file takes the env map: a builtin
    name renders its own sky, bitwise the same as without the flag."""
    sky = _sky(tmp_path / "sky.hdr")
    args = tcli.build_parser().parse_args(
        ["render", "--scene", "sphere_on_floor", "--env-map", sky])
    assert not tcli._build_scene(args).has_env_map
    outs = []
    for extra in ([], ["--env-map", sky]):
        out = tmp_path / f"o{len(outs)}.npy"
        tcli.main(["render", "--device", "cpu", "--scene", "sphere_on_floor",
                   *_FLAGS, *extra, "--out", str(out)])
        outs.append(np.load(out))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_train_env_map_cli(tmp_path, capsys):
    """train --env-map --device cpu at 16 x 16, 2 steps: the losses, the
    PNG, and an npz whose leaf0 is the fitted env image (the JAX leaf
    order puts env first and its image before its power), moved by the
    step."""
    sky = _sky(tmp_path / "sky.hdr")
    target = tmp_path / "target.npy"
    np.save(target, np.full((16, 16, 3), 0.3, np.float32))
    out = tmp_path / "fit.npz"
    loss, params, grads, img = tcli.cmd_train(tcli.build_parser().parse_args(
        ["train", "--device", "cpu", "--scene", _SCENE, "--env-map", sky,
         "--width", "16", "--height", "16", "--spp", "1", "--max-steps",
         "96", "--max-bounces", "2", "--steps", "2", "--lr", "1.0",
         "--relax", "1.9", "--normal-taps", "4", "--target", str(target),
         "--out", str(out)]))
    text = capsys.readouterr().out
    assert "step    0 loss" in text and "step    1 loss" in text
    assert (tmp_path / "fit.png").exists()
    assert float(grads["env"]["image"].abs().max()) > 0.0
    assert bool(torch.isfinite(img).all())
    with np.load(out) as z:
        fitted = z["leaf0"]
    assert fitted.shape == (16, 32, 3)
    assert not np.allclose(fitted, np.load(target).mean())
    np.testing.assert_array_equal(fitted, params["env"]["image"].numpy())
