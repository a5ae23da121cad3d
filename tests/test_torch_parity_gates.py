"""Port parity, the golden-image gates (`utils/parity.py`): every gate
function equal to the JAX package's on the packaged x4 goldens (numpy on
both sides, so equal value for value), and the port's copy of the
packaged data byte-identical to the JAX package's."""
import os
from pathlib import Path

import numpy as np
import pytest

from raymarchrenderer_tpu.utils import parity as jpar
from raymarchrenderer_tpu_torch.utils import parity as tpar

_REPO = Path(__file__).resolve().parent.parent
_NAMES = list(jpar.GATED_GOLDENS)


def test_packaged_data_is_a_byte_identical_copy():
    src = _REPO / "raymarchrenderer_tpu" / "data" / "parity"
    dst = _REPO / "raymarchrenderer_tpu_torch" / "data" / "parity"
    names = sorted(os.listdir(src))
    assert sorted(os.listdir(dst)) == names and len(names) == 6
    for n in names:
        assert (dst / n).read_bytes() == (src / n).read_bytes(), n
    assert Path(tpar.scene_path()) == dst / "default_parity.scene"


def test_constants_match():
    assert tpar.GATED_GOLDENS == jpar.GATED_GOLDENS
    assert (tpar.GOLDEN_EYE, tpar.GOLDEN_DIR) == (jpar.GOLDEN_EYE,
                                                  jpar.GOLDEN_DIR)


@pytest.mark.parametrize("name", _NAMES)
def test_gate_functions_match_jax(name):
    ref = tpar.load_golden(name, 4)
    np.testing.assert_array_equal(ref, jpar.load_golden(name, 4))
    assert ref.dtype == np.uint8 and ref.shape == (180, 320, 3)
    np.testing.assert_array_equal(tpar.luma(ref), jpar.luma(ref))
    # a stand-in render: another era's golden, shifted
    ours = np.roll(tpar.load_golden(_NAMES[(_NAMES.index(name) + 1)
                                           % len(_NAMES)], 4), 3, axis=1)
    assert tpar.ssim(tpar.luma(ref), tpar.luma(ours)) == jpar.ssim(
        jpar.luma(ref), jpar.luma(ours))
    for chan in range(3):
        assert tpar.channel_centroid(ref, chan) == jpar.channel_centroid(
            ref, chan)
        assert tpar.channel_bbox(ours, chan) == jpar.channel_bbox(ours, chan)
        mask = ref[..., chan] > 100
        tl, tn = tpar._label_components(mask)
        jl, jn = jpar._label_components(mask)
        assert tn == jn and np.array_equal(tl, jl)
    assert tpar.dist((1.0, 2.0), (4.0, 6.0)) == 5.0
    assert tpar.dist(None, (0.0, 0.0)) is None
    for f in (4, 8):
        want = jpar.gate_one(name, jpar.load_golden(name, f),
                             jpar.load_golden(name, f),
                             jpar.GATED_GOLDENS[name], f=f)
        got = tpar.gate_one(name, tpar.load_golden(name, f),
                            tpar.load_golden(name, f),
                            tpar.GATED_GOLDENS[name], f=f)
        assert got == want and got["pass"]       # a golden passes itself
    assert tpar.gate_one(name, ref, ours, tpar.GATED_GOLDENS[name], f=4) == \
        jpar.gate_one(name, ref, ours, jpar.GATED_GOLDENS[name], f=4)


def test_x4_goldens_refuse_a_scale_off_the_packaging():
    with pytest.raises(ValueError):
        tpar.load_golden(_NAMES[0], 6)
    np.testing.assert_array_equal(tpar.load_golden(_NAMES[0], 1),
                                  tpar.load_golden(_NAMES[0], 4))


def test_run_parity_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The port's `run_parity` end to end on the CPU oracle at x8 and 1
    sample (far from converged: the report's shape, not its verdict)."""
    import json
    monkeypatch.setenv("PARITY_SPP", "1")
    monkeypatch.setenv("PARITY_SCALE", "8")
    monkeypatch.setenv("PARITY_REF", _NAMES[0])
    rc = tpar.run_parity(out_dir=str(tmp_path), device="cpu")
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if report["pass"] else 1)
    assert report["size"] == [160, 90] and report["spp"] == 1
    assert report["platform"] == "cpu" and len(report["goldens"]) == 1
    g = report["goldens"][0]
    assert g["scale"] == 8 and set(g["gates"]) == {
        "red_centroid_lt_20px", "green_centroid_in_ref_panel_bbox",
        "green_centroid_lt_150px", "luma_pearson_r_floor"}
    assert (tmp_path / "reference_parity.png").exists()


def _mount(tmp_path, monkeypatch, names, shape=(720, 1280)):
    """A reference mount in `tmp_path` for both packages: the goldens
    `names` as full-resolution BMPs of seeded pixels under output/, and the
    packaged parity scene as data/scenes/default.scene; returns the
    scene's path."""
    import shutil

    from raymarchrenderer_tpu_torch.io.image import save_bmp
    out = tmp_path / "output"
    scenes = tmp_path / "data" / "scenes"
    out.mkdir()
    scenes.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for n in names:
        save_bmp(str(out / (n + ".bmp")),
                 rng.uniform(0.0, 1.0, shape + (3,)).astype(np.float32))
    scene = scenes / "default.scene"
    shutil.copy(tpar.scene_path(), scene)
    for mod in (tpar, jpar):
        monkeypatch.setattr(mod, "REF_DIR", str(out))
        monkeypatch.setattr(mod, "REF_SCENE", str(scene))
    return str(scene)


def test_full_resolution_goldens_match_jax(tmp_path, monkeypatch):
    """With the reference mount, `load_golden` reads the full-resolution
    BMP (the port's own `io.image.load_bmp`) and downscales it at any
    factor, as the JAX package's does on the same files; the mount's
    scene is `scene_path`."""
    scene = _mount(tmp_path, monkeypatch, _NAMES[:1])
    assert tpar.have_reference_mount() and jpar.have_reference_mount()
    assert tpar.scene_path() == jpar.scene_path() == scene
    for f in (1, 2, 3, 4):
        got = tpar.load_golden(_NAMES[0], f)
        assert got.dtype == np.uint8 and got.shape == (720 // f, 1280 // f,
                                                       3)
        np.testing.assert_array_equal(got, jpar.load_golden(_NAMES[0], f))
    # a golden the mount lacks: the packaged x4 array, as in JAX
    np.testing.assert_array_equal(tpar.load_golden(_NAMES[1], 4),
                                  jpar.load_golden(_NAMES[1], 4))


def test_reference_mount_needs_both_paths(tmp_path, monkeypatch):
    """`have_reference_mount` is the JAX package's test: the renders'
    directory and the reference's scene file both present; the parity
    scale is 1 with the mount by default and at least x4 without it."""
    import os
    scene = _mount(tmp_path, monkeypatch, [])
    monkeypatch.delenv("PARITY_SCALE", raising=False)
    assert tpar.have_reference_mount() and tpar.parity_scale() == 1
    monkeypatch.setenv("PARITY_SCALE", "2")
    assert tpar.parity_scale() == 2
    os.remove(scene)
    assert not tpar.have_reference_mount()
    assert not jpar.have_reference_mount()
    assert tpar.parity_scale() == 4
    assert tpar.scene_path().endswith("default_parity.scene")
    for path in (None, str(tmp_path / "missing")):
        monkeypatch.setattr(tpar, "REF_DIR", path)
        assert not tpar.have_reference_mount()


def test_run_parity_with_the_mount(tmp_path, monkeypatch, capsys):
    """`run_parity` with the mount: the full-resolution golden (a small
    seeded BMP here) at scale 1 by default, the mount's scene, and the
    report's `reference_mount` true (the report's shape, not its
    verdict)."""
    import json
    _mount(tmp_path, monkeypatch, _NAMES[:1], shape=(36, 64))
    monkeypatch.setenv("PARITY_SPP", "1")
    monkeypatch.delenv("PARITY_SCALE", raising=False)
    monkeypatch.setenv("PARITY_REF", _NAMES[0])
    rc = tpar.run_parity(out_dir=str(tmp_path), device="cpu")
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if report["pass"] else 1)
    assert report["reference_mount"] is True
    assert report["size"] == [64, 36] and report["goldens"][0]["scale"] == 1
