"""Port parity, the native host libraries (`io/native_bindings.py`): built
by g++ from the repository's `native/*.cpp` into the ignored `build/`
directory, held against the pure-Python encoders and decoder.

Bars: the native sRGB conversion within one level of the numpy OETF (the
JAX package's own bar, tests/test_native.py); BMP and PNG files byte for
byte the JAX package's Python writers' on the same 8-bit values; the
native .hdr decode equal to `loads_hdr`, flat and run-length scanlines.
"""
import os
from pathlib import Path

import numpy as np
import pytest

from raymarchrenderer_tpu.io import hdr as jhdr
from raymarchrenderer_tpu.io import image as jimage
from raymarchrenderer_tpu_torch.io import hdr as thdr
from raymarchrenderer_tpu_torch.io import image as timage
from raymarchrenderer_tpu_torch.io import native_bindings as nb

_REPO = Path(__file__).resolve().parent.parent


def test_libraries_build_into_the_ignored_build_directory():
    for lib in nb.LIBRARIES:
        assert lib.load() is not None, lib.error
        path = lib.library_path()
        assert path.exists() and path.name == f"lib{lib.name}.so"
        assert path.parent.parent == (
            _REPO / "build" / "raymarchrenderer_tpu_torch" / "native")
        assert len(path.parent.name) == 16     # the hashed directory
    # nothing is built into (or anywhere under) the JAX package
    jax_pkg = _REPO / "raymarchrenderer_tpu"
    assert not (jax_pkg / "io" / "_native").exists()
    assert not list(jax_pkg.rglob("*.so"))


def test_srgb_within_one_level_of_numpy():
    rng = np.random.default_rng(0)
    lin = (rng.random((64, 96, 3), np.float32) * 1.2 - 0.1).astype(
        np.float32)
    got = nb.linear_to_srgb_u8(lin)
    want = np.clip(np.round(jimage._linear_to_srgb_np(lin) * 255.0), 0,
                   255).astype(np.uint8)
    assert got.dtype == np.uint8 and got.shape == lin.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(timage.to_srgb_u8(lin), got)


@pytest.mark.parametrize("ext", ["bmp", "png"])
@pytest.mark.parametrize("shape", [(8, 10), (17, 5)])
def test_native_writer_bytes_equal_python(tmp_path, ext, shape):
    """The native writer of the JAX package's 8-bit values against the JAX
    package's Python writer of the same image (no native library is built
    for the JAX package)."""
    rng = np.random.default_rng(1)
    img = rng.random((*shape, 3)).astype(np.float32)
    u8 = jimage.to_srgb_u8(img)
    jpath, npath = tmp_path / f"j.{ext}", tmp_path / f"n.{ext}"
    getattr(jimage, f"save_{ext}")(str(jpath), img)
    getattr(nb, f"write_{ext}")(str(npath), u8)
    assert npath.read_bytes() == jpath.read_bytes()


def test_save_image_uses_the_native_encoder(tmp_path):
    img = np.random.default_rng(2).random((6, 7, 3)).astype(np.float32)
    before = dict(nb.ENCODER.calls)
    timage.save_image(str(tmp_path / "x.png"), img)
    timage.save_bmp(str(tmp_path / "x.bmp"), img)
    for fn in ("rmr_linear_to_srgb_u8", "rmr_write_png", "rmr_write_bmp"):
        assert nb.ENCODER.calls.get(fn, 0) > before.get(fn, 0), fn
    np.testing.assert_array_equal(timage.load_png(str(tmp_path / "x.png")),
                                  jimage.load_png(str(tmp_path / "x.png")))


def _rle_hdr(rgbe: np.ndarray) -> bytes:
    """A new-style run-length .hdr: each scanline's four components as
    runs (a byte > 128) where a value repeats, literals elsewhere."""
    h, w, _ = rgbe.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        out.append(bytes([2, 2, w >> 8, w & 255]))
        for c in range(4):
            comp = rgbe[y, :, c]
            i = 0
            while i < w:
                j = i
                while j < w and comp[j] == comp[i] and j - i < 127:
                    j += 1
                if j - i > 2:
                    out.append(bytes([128 + j - i, comp[i]]))
                    i = j
                    continue
                j = i
                while j < w and j - i < 128 and not (
                        j + 2 < w and comp[j] == comp[j + 1] == comp[j + 2]):
                    j += 1
                j = max(j, i + 1)
                out.append(bytes([j - i]) + comp[i:j].tobytes())
                i = j
    return b"".join(out)


def test_native_hdr_decode_equals_loads_hdr(tmp_path):
    rng = np.random.default_rng(3)
    rgb = (rng.random((9, 40, 3)) * 4.0).astype(np.float32)
    rgb[2, 5:30] = 0.25                  # runs in every component
    path = tmp_path / "flat.hdr"
    thdr.save_hdr(str(path), rgb)
    flat = path.read_bytes()
    rgbe = np.frombuffer(flat[-9 * 40 * 4:], np.uint8).reshape(9, 40, 4)
    rle = _rle_hdr(rgbe)
    assert rle.count(bytes([2, 2, 0, 40])) == 9     # every scanline RLE
    for data in (flat, rle):
        want = jhdr.loads_hdr(data)
        np.testing.assert_array_equal(thdr.loads_hdr(data), want)
        np.testing.assert_array_equal(nb.decode_hdr(data), want)
    (tmp_path / "rle.hdr").write_bytes(rle)
    before = nb.HDR.calls.get("rmr_hdr_decode", 0)
    np.testing.assert_array_equal(thdr.load_hdr(str(tmp_path / "rle.hdr")),
                                  jhdr.loads_hdr(rle))
    assert nb.HDR.calls["rmr_hdr_decode"] == before + 1


def test_a_failed_build_is_reported_once(capsys, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    lib = nb.NativeLibrary("bad", "bad.cpp", (), lambda lib: None)
    lib.source = bad
    assert lib.load() is None and lib.load() is None
    err = capsys.readouterr().err
    assert err.count("native library libbad unavailable") == 1
    assert "g++ failed on bad.cpp" in err and lib.error
    missing = nb.NativeLibrary("gone", "gone.cpp", (), lambda lib: None)
    missing.source = tmp_path / "gone.cpp"
    assert missing.load() is None and "not found" in missing.error
    assert not os.path.exists(lib.library_path())
