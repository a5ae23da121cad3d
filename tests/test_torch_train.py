"""Port parity, the train step and the `train` verb: one port
`train_step_sharded` against the JAX package's on a 1 x 1 CPU mesh, the
CLI end to end at a tiny size, what the slice refuses, the library's
device defaults, and the build of kernels that share a source.

Bars: the loss to rtol 1e-5 and every updated leaf to atol 1e-6 (lr 1e-2
times the gradient bars of tests/test_torch_diff.py).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import corners_to_torch, np_tree

from raymarchrenderer_tpu.core.camera import Camera as JCamera
from raymarchrenderer_tpu.parallel import sharding as jsharding
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.app import cli as tcli
from raymarchrenderer_tpu_torch.core import sh as tsh
from raymarchrenderer_tpu_torch.core.camera import Camera as TCamera
from raymarchrenderer_tpu_torch.kernels import build
from raymarchrenderer_tpu_torch.kernels import march as tmarch
from raymarchrenderer_tpu_torch.parallel import sharding as tsharding
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin
from raymarchrenderer_tpu_torch.scene import (param_leaves, params_from_numpy,
                                              params_to_numpy)


@pytest.mark.parametrize("impl", ["recorded", "oracle"])
def test_train_step_matches_jax(impl):
    """48 x 32, 2 samples, 3 bounces, lr 1e-2, remat on both sides, the
    target a seeded image.  Measured: loss relative difference below 1e-7,
    updated leaves within 3e-9."""
    kw = dict(width=48, height=32, max_steps=96, max_bounces=3,
              max_dist=100.0)
    js, ts = jbuiltin.sphere_on_floor(), tbuiltin.sphere_on_floor()
    jp = js.init_params()
    tp = params_from_numpy(np_tree(jp), "cpu")
    corners = JCamera(aspect=1.5).corner_rays_flat()
    target = np.random.RandomState(7).uniform(
        0.0, 0.5, (32, 48, 3)).astype(np.float32)
    mesh = jsharding.make_mesh(jsharding.ShardConfig(1, 1))
    with mesh:
        jloss, jnew = jsharding.train_step_sharded(
            js, jp, JCfg(**kw), corners, jnp.asarray(target), mesh, spp=2,
            lr=1e-2, march_impl=impl, interpret=True)
    tloss, tnew = tsharding.train_step_sharded(
        ts, tp, TCfg(**kw), corners_to_torch(corners),
        torch.from_numpy(target), spp=2, lr=1e-2, march_impl=impl)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = [np.asarray(a) for a in jax.tree.leaves(jnew)]
    got = params_to_numpy(tnew)
    assert len(want) == len(got) == 14
    moved = 0
    for a, b, a0 in zip(want, got, param_leaves(tp)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        moved += int(not np.array_equal(b, a0.numpy()))
    assert moved > 0


def test_train_cli_writes_jax_leaf_order(tmp_path, capsys):
    """`train --device cpu` at 32 x 32, 2 steps: the printed losses, the
    PNG, and an npz whose `leaf{i}` unflatten into the JAX package's
    parameter tree (the same shapes, leaf by leaf)."""
    target = tmp_path / "target.npy"
    np.save(target, np.full((32, 32, 3), 0.25, np.float32))
    out = tmp_path / "fit.npz"
    loss, params, grads, img = tcli.cmd_train(tcli.build_parser().parse_args(
        ["train", "--device", "cpu", "--width", "32", "--height", "32",
         "--spp", "2", "--max-steps", "96", "--max-bounces", "3",
         "--steps", "2", "--relax", "1.9", "--normal-taps", "4",
         "--target", str(target), "--out", str(out)]))
    text = capsys.readouterr().out
    assert "step    0 loss" in text and "step    1 loss" in text
    assert out.exists() and (tmp_path / "fit.png").exists()
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in param_leaves(grads))
    leaves, treedef = jax.tree.flatten(jbuiltin.sphere_on_floor()
                                       .init_params())
    with np.load(out) as z:
        saved = [z[f"leaf{i}"] for i in range(len(z.files))]
    assert len(saved) == len(leaves)
    tree = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in saved])
    for a, b in zip(jax.tree.leaves(tree), leaves):
        assert a.shape == b.shape
    np.testing.assert_array_equal(
        np.asarray(tree["objects"][1][0]),
        params["objects"][1][0].numpy())      # the ball's centre, by name


def test_train_spectral_refused(tmp_path, capsys):
    """`train --spectral` is ported (tests/test_torch_cli_spectral.py),
    and so is the exact normal it used to refuse: `--normal-taps 0` takes
    a step and writes its npz; the CLI still refuses a count of taps it
    does not know."""
    target = tmp_path / "t.npy"
    np.save(target, np.zeros((8, 8, 3), np.float32))
    flags = ["train", "--spectral", "--device", "cpu", "--width", "8",
             "--height", "8", "--max-steps", "16", "--max-bounces", "2",
             "--spp", "1", "--steps", "1", "--target", str(target)]
    out = tmp_path / "fit.npz"
    assert tcli.main(flags + ["--normal-taps", "0", "--out", str(out)]) == 0
    assert out.exists() and "step    0 loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcli.main(flags + ["--normal-taps", "5"])


def test_library_defaults_to_the_card(tmp_path):
    """Without a card the library's defaults raise instead of handing back
    CPU tensors, and `train` without --device fails."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    scene = tbuiltin.sphere_on_floor()
    with pytest.raises((AssertionError, RuntimeError)):
        scene.init_params()
    with pytest.raises((AssertionError, RuntimeError)):
        TCamera().corner_rays_flat()
    with pytest.raises((AssertionError, RuntimeError)):
        tsh.bake_latlong(tsh.constant_coeffs(0.5), 4, 8)
    target = tmp_path / "t.npy"
    np.save(target, np.zeros((8, 8, 3), np.float32))
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["train", "--width", "8", "--height", "8", "--target",
                   str(target)])


def test_kernels_of_one_source_build_once(tmp_path, monkeypatch):
    """MEGA_PATHS and RECORD_PATHS name one source, so one library path;
    built from two threads at once, nvcc runs once and both load it (a
    stand-in nvcc and loader: this machine has no CUDA toolkit)."""
    assert (tmarch.MEGA_PATHS.library_path()
            == tmarch.RECORD_PATHS.library_path())
    assert (tmarch.MARCH_FUSED.library_path()
            != tmarch.MEGA_PATHS.library_path())
    # the other recorders: entries of the render sources
    assert (tmarch.RECORD_WAVEFRONT.library_path()
            == tmarch.WAVEFRONT_PATHS.library_path())
    assert (tmarch.RECORD_SPECTRAL.library_path()
            == tmarch.MEGA_SPECTRAL.library_path())
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        time.sleep(0.2)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return type("Proc", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    kernels = [build.CudaKernel("mega_paths.cu", e, [])
               for e in ("rmr_mega_paths", "rmr_record_paths")]
    threads = [threading.Thread(target=k.build) for k in kernels]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert all(k._fn is not None for k in kernels)
    assert sorted(k.build_seconds > 0.0 for k in kernels) == [False, True]
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        kernels[0].library_path().name]
