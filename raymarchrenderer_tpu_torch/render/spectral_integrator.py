"""Gen-3 spectral transport pieces (`RayMarch3.glsl:251-345`).

Per-path state is one wavelength (nm, 5 nm bins, 0 == "unset") plus a
scalar power.  Materials are `ColorRange` band filters times a power
multiplier; emitters sample a wavelength from their band on first contact
and end the path; surfaces bounce into a uniform hemisphere.  The sky is a
390-830 nm emitter of power `cfg.sky_power`.

This module holds the band table and the band filter; the megakernel
schedule that uses them is `render/mega.py`.  The wavefront oracle
`trace_spectral` / `render_spectral` is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raymarchrenderer_tpu_torch.scene.graph import Scene


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
    """Per-lane band-table row at material index `mid`, clipped to the
    table like the JAX package's where-chain (a miss's -1 reads row 0)."""
    n = mats.min_wave.shape[0]
    if n == 0:
        z = torch.zeros_like(mid, dtype=torch.float32)
        return z, z, z, torch.zeros_like(mid)
    midc = torch.clamp(mid, 0, n - 1).long()
    return (mats.min_wave[midc], mats.max_wave[midc], mats.power[midc],
            mats.kind[midc])


def _apply_band(wl, power, u, min_w, max_w, mat_p):
    """One `mat_func_N` body (`RayMarch3.glsl:251-281`).

    unset (wl == 0): wl = floor(u*(max-min)/5)*5 + min, power *= p.
    set: outside [min, max] -> absorbed (wl := 0, terminate);
         inside -> power *= p.  Returns (wl, power, absorbed)."""
    r = u * (max_w - min_w) / 5.0
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


def spectral_demo(device="cuda"):
    """The gen-3 hardcoded scene (`RayMarch3.glsl:132-143,251-345`):
    `sphere_on_floor` with its band table (file twin
    `data/scenes/spectral.scene`) on `device` (the card by default).
    Returns (scene, params, mats)."""
    from raymarchrenderer_tpu_torch.scene.builtin import sphere_on_floor
    scene = sphere_on_floor()
    return scene, scene.init_params(device), band_table(scene, device)
