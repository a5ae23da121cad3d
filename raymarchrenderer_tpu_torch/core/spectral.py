"""Wavelength -> RGB for the gen-3 spectral transport.

Per-path state is one wavelength (nm, 5 nm bins; 0 == "unset") and a scalar
power; the final splat is `wavelengthToColor(lambda) * power`
(`RayMarch3.glsl:447-522`, piecewise-linear spectrum -> RGB).  Wavelengths
are float32 holding integral multiples of 5.  `sample_band` and
`band_filter` are the `mat_func_*` emitter draw and the `ColorRange` band
filter (`RayMarch3.glsl:261-280`) on their own.
"""
from __future__ import annotations

import torch

from .vecmath import Vec3, div


def wavelength_to_rgb(wl: torch.Tensor) -> Vec3:
    """Piecewise-linear spectrum -> RGB with the edge-fade alpha rolloff,
    the same where-chain as the JAX package; out-of-gamut maps to black."""
    wl = wl.to(torch.float32)
    zero = torch.zeros_like(wl)

    r = torch.where((wl >= 380) & (wl < 440), -div(wl - 440.0, 440.0 - 380.0),
                    zero)
    r = torch.where((wl >= 510) & (wl < 580), div(wl - 510.0, 580.0 - 510.0), r)
    r = torch.where((wl >= 580) & (wl < 645), 1.0, r)
    r = torch.where((wl >= 645) & (wl <= 780), 1.0, r)

    g = torch.where((wl >= 440) & (wl < 490), div(wl - 440.0, 490.0 - 440.0),
                    zero)
    g = torch.where((wl >= 490) & (wl < 510), 1.0, g)
    g = torch.where((wl >= 510) & (wl < 580), 1.0, g)
    g = torch.where((wl >= 580) & (wl < 645), -div(wl - 645.0, 645.0 - 580.0),
                    g)

    b = torch.where((wl >= 380) & (wl < 440), 1.0, zero)
    b = torch.where((wl >= 440) & (wl < 490), 1.0, b)
    b = torch.where((wl >= 490) & (wl < 510), -div(wl - 510.0, 510.0 - 490.0),
                    b)

    alpha = torch.where((wl > 780) | (wl < 380), 0.0, torch.ones_like(wl))
    alpha = torch.where((wl > 700) & (wl <= 780),
                        div(780.0 - wl, 780.0 - 700.0), alpha)
    alpha = torch.where((wl < 420) & (wl >= 380),
                        div(wl - 380.0, 420.0 - 380.0), alpha)

    return Vec3(r * alpha, g * alpha, b * alpha)


def sample_band(u, min_wave, max_wave):
    """A wavelength of a band in 5 nm bins (`RayMarch3.glsl:261-266`):
    r = u * (max - min) / 5; wl = floor(r) * 5 + min."""
    r = div(u * (max_wave - min_wave), 5.0)
    return torch.floor(r) * 5.0 + min_wave


def band_filter(wl, power, min_wave, max_wave, mat_power):
    """A `ColorRange` band filter (`RayMarch3.glsl:268-280`): a wavelength
    outside [min, max] is killed (wl -> 0, the path ends), inside it
    power *= mat_power.  Returns (wl, power, absorbed)."""
    inside = (wl >= min_wave) & (wl <= max_wave)
    new_wl = torch.where(inside, wl, 0.0)
    new_power = torch.where(inside, power * mat_power, power)
    return new_wl, new_power, ~inside
