"""Checkpoint / resume of progressive renders.

The reference's accumulation buffer is its checkpoint: the running mean
keyed by `currentSample` stays valid at any interruption
(`RayMarch3.glsl:542-554`, Escape-to-cancel `Program.cpp:188-194`).  A
checkpoint holds `(accum, n)` and the render config (its seed among it)
in one .npz; the RNG is counter-based, so there is no generator state to
save and a render resumes on any device.

The file layout is the JAX package's (`raymarchrenderer_tpu.io.checkpoint`):
`accum` float32 (H, W, 3), `n` float64, `config` the config's JSON as
uint8 bytes, and an optional `scene_digest` as uint8 bytes.  So:

  * a file without a digest loads in both packages;
  * the digest is each package's own (the JAX package hashes `repr(scene)`
    and a JAX treedef; this one hashes the scene as the kernels see it,
    `scene_digest`), so a digest written by one package is refused by the
    other with `SceneMismatchError`: the safe direction;
  * this package refuses a checkpoint of a different scene and accepts one
    of the same scene built again.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np

from raymarchrenderer_tpu_torch.render.config import RenderConfig

_DIGEST_TAG = b"raymarchrenderer_tpu_torch scene digest 1\n"


class RenderState(NamedTuple):
    accum: np.ndarray   # (H, W, 3) float32 linear running mean
    n: float            # samples accumulated so far
    cfg: RenderConfig
    scene_digest: Optional[str] = None  # identity of the scene that made it


class SceneMismatchError(RuntimeError):
    """Resuming a checkpoint against another scene than the one that made
    it: continuing would blend two scenes' images into one buffer."""


def scene_digest(scene, params) -> str:
    """SHA-256 of the scene as the kernels see it: the RGB kernels' int32
    program and float32 data (`kernels.scene_program.paths_buffers`: the
    object and material programs, lights, sky), the spectral kernels'
    (`spectral_buffers` over `band_table(scene)`), then every parameter
    leaf in the JAX package's leaf order (`params_to_numpy`) with its
    shape, dtype and bytes.  Two renders accumulate compatibly iff their
    digests are equal."""
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        paths_buffers, spectral_buffers)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)
    from raymarchrenderer_tpu_torch.scene.graph import params_to_numpy

    h = hashlib.sha256(_DIGEST_TAG)
    cpu = "cpu"
    buffers = (paths_buffers(scene, params, cpu)[:2]
               + spectral_buffers(scene, params, band_table(scene, cpu),
                                  cpu)[:2])
    for buf in buffers:
        a = buf.contiguous().numpy()
        h.update(f"{a.dtype} {a.shape}\n".encode())
        h.update(a.tobytes())
    for leaf in params_to_numpy(params):
        a = np.ascontiguousarray(leaf)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, accum, n: float, cfg: RenderConfig,
                    scene_digest: Optional[str] = None) -> None:
    """Write (accum, n, cfg[, scene_digest]) to `path` exactly (no `.npz`
    suffix is added).  `accum` is a numpy array or a tensor on any
    device."""
    if hasattr(accum, "detach"):
        accum = accum.detach().cpu().numpy()
    arrays = dict(
        accum=np.asarray(accum, np.float32),
        n=np.float64(n),
        config=np.frombuffer(cfg.to_json().encode(), dtype=np.uint8))
    if scene_digest is not None:
        arrays["scene_digest"] = np.frombuffer(
            scene_digest.encode(), dtype=np.uint8)
    # through a file object: np.savez_compressed(str_path) appends ".npz",
    # and `--resume`, which stats the exact path, would never find it
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_checkpoint(path: str,
                    expect_scene_digest: Optional[str] = None) -> RenderState:
    """Load a checkpoint; where both the file and the caller carry a scene
    digest and they differ, raise `SceneMismatchError` instead of resuming
    one scene's buffer under another.  A file without a digest loads
    without the check."""
    with np.load(path) as z:
        cfg = RenderConfig.from_json(bytes(z["config"].tobytes()).decode())
        digest = (bytes(z["scene_digest"].tobytes()).decode()
                  if "scene_digest" in z else None)
        if (expect_scene_digest is not None and digest is not None
                and digest != expect_scene_digest):
            raise SceneMismatchError(
                f"checkpoint {path} was made by another scene (digest "
                f"{digest[:12]}… != expected {expect_scene_digest[:12]}…); "
                f"refusing to blend two scenes into one accumulation buffer")
        return RenderState(z["accum"], float(z["n"]), cfg, digest)
