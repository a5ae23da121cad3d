"""Port parity, checkpoint / resume: `io/checkpoint.py` and `render
--checkpoint PATH --resume`.

The file layout is the JAX package's, so files without a scene digest
load in both packages; each package's digest is its own, so a digest of
one is refused by the other (`SceneMismatchError`, the safe direction).
A resumed render keeps the chunk boundaries of an uninterrupted one with
the same `--chunk`, and the RNG is counter-based: its image is byte-equal
to the uninterrupted run's, RGB and spectral, fused (the kernels' plain
versions here) and oracle.
"""
import numpy as np
import pytest
import torch

from raymarchrenderer_tpu.io import checkpoint as jckpt
from raymarchrenderer_tpu.render.config import RenderConfig as JCfg
from raymarchrenderer_tpu.scene import builtin as jbuiltin
from raymarchrenderer_tpu_torch.app import cli as tcli
from raymarchrenderer_tpu_torch.io import checkpoint as tckpt
from raymarchrenderer_tpu_torch.render.config import RenderConfig as TCfg
from raymarchrenderer_tpu_torch.scene import builtin as tbuiltin

_CFG = dict(width=12, height=8, spp=4, max_steps=64, max_bounces=3,
            seed=7)
_FLAGS = ["--device", "cpu", "--width", "16", "--height", "16",
          "--max-steps", "96", "--max-bounces", "3", "--chunk", "2"]


def _accum(seed=0):
    return np.random.default_rng(seed).random((8, 12, 3), np.float32)


def test_round_trip_keeps_the_layout(tmp_path):
    path = tmp_path / "render.ckpt"          # no suffix is added
    acc = _accum()
    tckpt.save_checkpoint(str(path), torch.from_numpy(acc), 24.0,
                          TCfg(**_CFG), scene_digest="ab" * 32)
    assert path.exists() and not (tmp_path / "render.ckpt.npz").exists()
    st = tckpt.load_checkpoint(str(path))
    np.testing.assert_array_equal(st.accum, acc)
    assert st.accum.dtype == np.float32 and st.n == 24.0
    assert st.cfg == TCfg(**_CFG) and st.scene_digest == "ab" * 32
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "config", "n", "scene_digest"]
        assert z["n"].dtype == np.float64 and z["config"].dtype == np.uint8


def test_digest_identifies_the_scene():
    a, b = tbuiltin.csg_demo(), tbuiltin.csg_demo()
    pa, pb = a.init_params("cpu"), b.init_params("cpu")
    assert tckpt.scene_digest(a, pa) == tckpt.scene_digest(b, pb)
    other = tbuiltin.sphere_on_floor()
    assert tckpt.scene_digest(other, other.init_params("cpu")) != \
        tckpt.scene_digest(a, pa)
    pb["objects"][1][1] = pb["objects"][1][1] + 1e-6     # one leaf moved
    assert tckpt.scene_digest(b, pb) != tckpt.scene_digest(a, pa)


def test_port_refuses_another_scene_and_accepts_the_same(tmp_path):
    path = str(tmp_path / "c.npz")
    scene = tbuiltin.csg_demo()
    digest = tckpt.scene_digest(scene, scene.init_params("cpu"))
    tckpt.save_checkpoint(path, _accum(), 4.0, TCfg(**_CFG),
                          scene_digest=digest)
    again = tbuiltin.csg_demo()
    st = tckpt.load_checkpoint(path, tckpt.scene_digest(
        again, again.init_params("cpu")))
    assert st.scene_digest == digest
    other = tbuiltin.sphere_on_floor()
    with pytest.raises(tckpt.SceneMismatchError):
        tckpt.load_checkpoint(path, tckpt.scene_digest(
            other, other.init_params("cpu")))


def test_each_package_refuses_the_others_digest(tmp_path):
    jscene, tscene = jbuiltin.csg_demo(), tbuiltin.csg_demo()
    jdig = jckpt.scene_digest(jscene, jscene.init_params())
    tdig = tckpt.scene_digest(tscene, tscene.init_params("cpu"))
    assert jdig != tdig
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, _accum(), 2.0, JCfg(**_CFG),
                          scene_digest=jdig)
    tckpt.save_checkpoint(tpath, _accum(), 2.0, TCfg(**_CFG),
                          scene_digest=tdig)
    with pytest.raises(tckpt.SceneMismatchError):
        tckpt.load_checkpoint(jpath, tdig)
    with pytest.raises(jckpt.SceneMismatchError):
        jckpt.load_checkpoint(tpath, jdig)


def test_digest_less_files_load_in_both_packages(tmp_path):
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_checkpoint(jpath, _accum(1), 3.0, JCfg(**_CFG))
    tckpt.save_checkpoint(tpath, _accum(2), 5.0, TCfg(**_CFG))
    from_jax = tckpt.load_checkpoint(jpath, expect_scene_digest="x" * 64)
    from_port = jckpt.load_checkpoint(tpath, expect_scene_digest="y" * 64)
    np.testing.assert_array_equal(from_jax.accum, _accum(1))
    np.testing.assert_array_equal(from_port.accum, _accum(2))
    assert (from_jax.n, from_port.n) == (3.0, 5.0)
    assert from_jax.cfg == TCfg(**_CFG) and from_port.cfg == JCfg(**_CFG)
    assert from_jax.scene_digest is None and from_port.scene_digest is None


def _render(tmp_path, name, spp, *extra):
    out = tmp_path / f"{name}.npy"
    assert tcli.main(["render", *_FLAGS, "--spp", str(spp), *extra,
                      "--out", str(out)]) == 0
    return np.load(out)


@pytest.mark.parametrize("impl", ["fused", "oracle"])
@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
def test_resumed_render_is_byte_equal(tmp_path, capsys, impl, spectral):
    """A render stopped after its first chunk of 2 (its checkpoint) and
    resumed to 4 samples equals the uninterrupted 4-sample run."""
    flags = ["--impl", impl] + (["--spectral"] if spectral else
                                ["--scene", "csg", "--direct-light"])
    ckpt = str(tmp_path / "render.ckpt")
    first = _render(tmp_path, "first", 2, *flags, "--checkpoint", ckpt)
    st = tckpt.load_checkpoint(ckpt)
    np.testing.assert_array_equal(st.accum, first)
    assert st.n == 2.0 and st.scene_digest is not None
    resumed = _render(tmp_path, "resumed", 4, *flags, "--checkpoint", ckpt,
                      "--resume")
    assert "resuming at 2 spp" in capsys.readouterr().out
    whole = _render(tmp_path, "whole", 4, *flags)
    assert whole.mean() > 0.0
    np.testing.assert_array_equal(resumed, whole)
    assert tckpt.load_checkpoint(ckpt).n == 4.0


def test_resume_extends_a_finished_render(tmp_path):
    """`--resume --spp 6` adds two samples to a finished 4-sample render;
    `--resume` at the finished count renders nothing new."""
    ckpt = str(tmp_path / "render.ckpt")
    flags = ["--impl", "fused", "--checkpoint", ckpt]
    done = _render(tmp_path, "done", 4, *flags)
    same = _render(tmp_path, "same", 4, *flags, "--resume")
    np.testing.assert_array_equal(same, done)
    more = _render(tmp_path, "more", 6, *flags, "--resume")
    np.testing.assert_array_equal(more, _render(tmp_path, "whole", 6,
                                                "--impl", "fused"))
    assert tckpt.load_checkpoint(ckpt).n == 6.0


def test_resume_refuses_another_scene(tmp_path):
    ckpt = str(tmp_path / "render.ckpt")
    _render(tmp_path, "a", 2, "--impl", "fused", "--checkpoint", ckpt)
    with pytest.raises(tckpt.SceneMismatchError):
        _render(tmp_path, "b", 4, "--impl", "fused", "--scene", "csg",
                "--checkpoint", ckpt, "--resume")
