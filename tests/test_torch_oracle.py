"""Port parity, the oracle progressive render (`render --impl oracle`):
the port's `render` against the committed regression goldens of the JAX
package (`tests/goldens/*.npy`: its oracle `render` on the CPU, 64 x 64,
4 samples, 96 steps, 3 bounces; `tools/make_goldens.py`'s `SCENES`,
`REG_CFG` and `CAMERAS`), so no JAX function is compiled here; and the
spectral oracle and the CLI's `--impl` against the JAX package's.

Bar: the JAX package's image bar, fewer than 1e-3 of the values off by
more than 1e-5 (a path flipped by XLA:CPU's ulp-off sqrt, sin and cos
moves a value by far more than 1e-5; a value that matches matches to the
last few ulps).
"""
import os
import sys

import numpy as np
import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, frac_off

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools.make_goldens import CAMERAS, REG_CFG, REG_SPP, SCENES  # noqa: E402

from raymarchrenderer_tpu_torch.app import cli as tcli
from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.render import integrator as tint
from raymarchrenderer_tpu_torch.render import spectral_integrator as tspec
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.scene import builtin, load_scene

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLD = os.path.join(_REPO, "tests", "goldens")
_BUILTINS = {"csg": "csg_demo", "glass": "glass_demo",
             "volume": "volume_demo"}


def _scene(name, path):
    if path:
        return load_scene(os.path.join(_REPO, path))
    return getattr(builtin, _BUILTINS.get(name, name))()


def _corners(name):
    cam = Camera(aspect=1.0)
    if name in CAMERAS:
        cam.eye = CAMERAS[name][0]
        cam.look_at(CAMERAS[name][1])
    return cam.corner_rays_flat("cpu")


@pytest.mark.parametrize("name,path", SCENES, ids=[n for n, _ in SCENES])
def test_oracle_render_matches_golden(name, path):
    """Measured: 0 values off by more than 1e-5 on 11 scenes (largest
    difference 9.5e-7: ulps of the running mean's weights); multilight 3
    values (one pixel, 2.4e-4 of the values) off by up to 3.75, one path
    that hits another surface in the two packages (not traced to its op
    here; XLA:CPU's sqrt, sin and cos are the known ulp sources)."""
    scene = _scene(name, path)
    img, n = tint.render(scene, scene.init_params("cpu"),
                         RenderConfig(**REG_CFG), _corners(name),
                         spp=REG_SPP)
    gold = np.load(os.path.join(_GOLD, f"{name}.npy"))
    assert n == REG_SPP and img.shape == gold.shape == (64, 64, 3)
    assert frac_off(gold, img.numpy()) < MAX_FRAC_OFF


def test_progressive_resume_and_fused_sample():
    """`render` resumed from (accum, n0) equals the straight run bitwise
    (the counter-based RNG), and `render_sample_fused` is one sample of
    the RGB kernel (its plain version on the CPU) as a stacked image."""
    scene = builtin.sphere_on_floor()
    params = scene.init_params("cpu")
    cfg = RenderConfig(**REG_CFG).replace(width=24, height=16)
    corners = Camera(aspect=1.5).corner_rays_flat("cpu")
    full, n = tint.render(scene, params, cfg, corners, spp=4)
    half, n2 = tint.render(scene, params, cfg, corners, spp=2)
    rest, n4 = tint.render(scene, params, cfg, corners, spp=2, accum=half,
                           n0=n2)
    assert (n, n4) == (4.0, 4.0)
    np.testing.assert_array_equal(rest.numpy(), full.numpy())
    got = tmarch.render_sample_fused(scene, params, cfg, corners, 3)
    want = tmarch.render_fused(scene, params, cfg, corners, 3, n_samples=1)
    assert got.shape == (16, 24, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_spectral_oracle_matches_jax():
    """`render_spectral` against the JAX package's, 32 x 24, 2 samples
    (measured: 0 values off by more than 1e-5)."""
    import jax.numpy as jnp
    from _torch_parity import corners_to_torch, mats_to_torch, np_tree
    from raymarchrenderer_tpu.core.camera import Camera as JCamera
    from raymarchrenderer_tpu.render import spectral_integrator as jspec
    from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
    from raymarchrenderer_tpu_torch.scene import params_from_numpy

    kw = dict(width=32, height=24, max_steps=96, max_bounces=3,
              max_dist=100.0)
    js, jp, jm = jspec.spectral_demo()
    ts = builtin.sphere_on_floor()
    corners = JCamera(aspect=32 / 24).corner_rays_flat()
    want, _ = jspec.render_spectral(js, jp, jm, JCfg(**kw), corners, spp=2)
    got, n = tspec.render_spectral(
        ts, params_from_numpy(np_tree(jp), "cpu"), mats_to_torch(jm),
        RenderConfig(**kw), corners_to_torch(corners), spp=2)
    assert n == 2.0 and float(jnp.mean(want)) > 0.0
    assert frac_off(np.asarray(want), got.numpy()) < MAX_FRAC_OFF


@pytest.mark.parametrize("impl", ["auto", "fused", "oracle"])
def test_render_impl_flag(tmp_path, capsys, impl):
    """`render --impl`: auto takes the oracle on the CPU (the JAX CLI's
    `_pick_impl`: fused on the accelerator, oracle elsewhere); fused is
    `render_progressive_fused` in launches of `--chunk` samples, oracle
    `integrator.render`, bitwise; the .exr written holds the image.  (The
    two differ where the fused schedule's lazy miss test lets a lane past
    the step budget: its pass boundaries are semantics.)"""
    from raymarchrenderer_tpu_torch.io.image import load_exr
    assert tcli.pick_impl("auto", torch.device("cpu")) == "oracle"
    assert tcli.pick_impl("auto", torch.device("cuda", 0)) == "fused"
    assert tcli.pick_impl("fused", torch.device("cpu")) == "fused"
    out = tmp_path / "o.exr"
    args = tcli.build_parser().parse_args(
        ["render", "--device", "cpu", "--width", "16", "--height", "16",
         "--spp", "3", "--chunk", "2", "--max-steps", "96", "--max-bounces",
         "3", "--impl", impl, "--out", str(out)])
    img, n, _ = tcli.cmd_render(args)
    picked = "oracle" if impl == "auto" else impl
    assert f"with the {picked} path" in capsys.readouterr().out
    np.testing.assert_array_equal(load_exr(str(out)), img.numpy())
    scene = builtin.sphere_on_floor()
    cfg = RenderConfig(width=16, height=16, spp=3, max_steps=96,
                       max_bounces=3)
    corners = Camera(aspect=1.0).corner_rays_flat("cpu")
    if picked == "fused":
        want, _ = tmarch.render_progressive_fused(
            scene, scene.init_params("cpu"), cfg, corners,
            samples_per_launch=2)
    else:
        want, _ = tint.render(scene, scene.init_params("cpu"), cfg, corners)
    assert n == 3.0
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def test_exr_bytes_match_jax(tmp_path):
    """`save_image(.exr)` writes the JAX package's bytes, and the port's
    reader gets the image back."""
    from raymarchrenderer_tpu.io.image import save_exr as jsave
    from raymarchrenderer_tpu_torch.io.image import load_exr, save_image
    img = np.random.RandomState(11).uniform(0.0, 4.0, (7, 5, 3)).astype(
        np.float32)
    jsave(str(tmp_path / "j.exr"), img)
    save_image(str(tmp_path / "t.exr"), img)
    assert (tmp_path / "t.exr").read_bytes() == (
        tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(load_exr(str(tmp_path / "t.exr")), img)


if __name__ == "__main__":
    # the readings the golden test's docstring states: per scene, the
    # values off by more than 1e-5, their fraction, the largest difference
    for name, path in SCENES:
        scene = _scene(name, path)
        img, _ = tint.render(scene, scene.init_params("cpu"),
                             RenderConfig(**REG_CFG), _corners(name),
                             spp=REG_SPP)
        d = np.abs(np.load(os.path.join(_GOLD, f"{name}.npy")) - img.numpy())
        print(f"{name}: {int((d > 1e-5).sum())} values off by more than "
              f"1e-5 ({float((d > 1e-5).mean()):.3e}), largest "
              f"{float(d.max()):.3e}")
