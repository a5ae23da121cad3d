"""The gen-3 band table and band filter (`RayMarch3.glsl:251-345`): a
frozen copy of the port's `render/spectral_integrator.py` pieces that the
megakernel schedules read (`SpectralMaterials`, `_lookup`, `_apply_band`,
`band_table`)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rmbench.reference.graph import Scene
from rmbench.reference.vecmath import div


class SpectralMaterials(NamedTuple):
    """SoA band-filter table, one row per scene material index.

    kind 0 = surface (band filter then hemisphere bounce); kind 1 = emitter
    (band filter then terminate, `RayMarch3.glsl:380`)."""
    min_wave: torch.Tensor   # f32[M]
    max_wave: torch.Tensor   # f32[M]
    power: torch.Tensor      # f32[M]
    kind: torch.Tensor       # i32[M]

    @staticmethod
    def from_numpy(min_wave, max_wave, power, kind,
                   device) -> "SpectralMaterials":
        """Four array-likes (e.g. the JAX package's table fields after
        `np.asarray`) -> the table on `device`."""
        f32 = [torch.as_tensor(np.array(a, np.float32), device=device)
               for a in (min_wave, max_wave, power)]
        k = torch.as_tensor(np.array(kind, np.int32), device=device)
        return SpectralMaterials(*f32, k)

    @staticmethod
    def table(rows, device) -> "SpectralMaterials":
        """rows: sequence of (min_wave, max_wave, power, kind)."""
        a = np.asarray(rows, np.float32).reshape(-1, 4)
        return SpectralMaterials.from_numpy(a[:, 0], a[:, 1], a[:, 2],
                                            a[:, 3].astype(np.int32), device)


def _lookup(mats: SpectralMaterials, mid: torch.Tensor):
    """Per-lane band-table row (min_wave, max_wave, power, kind) at
    material index `mid`, clipped to the table (a miss's -1 reads row 0),
    as the JAX package's where-chain over the rows.  A gather gives the
    same values, but its backward adds every lane's gradient into a
    handful of rows with atomics, which serialise on the card (5.3 s of a
    5.4 s spectral train step at 1024^2 x 4 samples); the where-chain's
    backward is one reduction per row."""
    z = torch.zeros(mid.shape, dtype=torch.float32, device=mid.device)
    rows = [z, z, z, torch.zeros_like(mid)]
    midc = torch.clamp(mid, 0, mats.min_wave.shape[0] - 1)
    for i in range(mats.min_wave.shape[0]):
        sel = midc == i
        rows = [torch.where(sel, col[i], r) for col, r in zip(mats, rows)]
    return tuple(rows)


def _apply_band(wl, power, u, min_w, max_w, mat_p):
    """One `mat_func_N` body (`RayMarch3.glsl:251-281`).

    unset (wl == 0): wl = floor(u*(max-min)/5)*5 + min, power *= p.
    set: outside [min, max] -> absorbed (wl := 0, terminate);
         inside -> power *= p.  Returns (wl, power, absorbed)."""
    r = div(u * (max_w - min_w), 5.0)
    sampled = torch.floor(r) * 5.0 + min_w
    unset = wl == 0.0
    outside = (wl < min_w) | (wl > max_w)
    new_wl = torch.where(unset, sampled, torch.where(outside, 0.0, wl))
    new_power = torch.where(unset | ~outside, power * mat_p, power)
    absorbed = ~unset & outside
    return new_wl, new_power, absorbed


def default_band_table(scene: Scene, device) -> SpectralMaterials:
    """Neutral gen-3 table for an RGB scene: emissive materials become
    380-780 nm power-8 emitter bands, everything else a 380-780 nm x0.8
    filter."""
    rows = [(380.0, 780.0, 8.0, 1) if scene.is_emissive(i)
            else (380.0, 780.0, 0.8, 0)
            for i in range(len(scene.materials))]
    return SpectralMaterials.table(rows, device)


def band_table(scene: Scene, device) -> SpectralMaterials:
    """The scene's authored `spectral` rows when present, else the neutral
    default."""
    if scene.spectral_rows:
        return SpectralMaterials.table(scene.spectral_rows, device)
    return default_band_table(scene, device)
