"""Colour transfer functions and channel helpers on tensors.

The reference keeps a linear accumulation buffer and applies the sRGB OETF
at save time (`Graphics.cpp:761-786`: c <= 0.0031308 ? 12.92 c :
1.055 c^(1/2.4) - 0.055); one explicit OETF at encode time, as in the JAX
package's `core/color.py`, whose op order these keep (clip, then the
`where` of the two branches, the power of max(c, 1e-12)).

`grayscale` is `RayMarch.glsl:306-309`: the channel sum over the active
channel mask's sum, which drives per-channel (dispersion) rendering.
`io/image.py` keeps its numpy encoders for the writers.
"""
from __future__ import annotations

import torch

from .vecmath import Vec3, div


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 x ** float32(e), computed in float64 and rounded once:
    within an ulp of XLA:CPU's float32 `pow`, where torch's float32 `pow`
    (a vectorised approximation on the CPU) is up to 11 ulps off it at
    e = 2.4."""
    e32 = float(torch.tensor(e, dtype=torch.float32))
    return torch.pow(x.to(torch.float64), e32).to(torch.float32)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * _pow(torch.clamp(c, min=1e-12), 1.0 / 2.4)
                       - 0.055)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, div(c, 12.92),
                       _pow(div(c + 0.055, 1.055), 2.4))


def encode_srgb_u8(rgb_linear: torch.Tensor) -> torch.Tensor:
    """Linear float image (..., 3) -> sRGB uint8, one OETF; rounds half to
    even, as `jnp.round`."""
    return torch.round(linear_to_srgb(rgb_linear) * 255.0).to(torch.uint8)


def grayscale(color: Vec3, channels: Vec3):
    """(r + g + b) / (ch.r + ch.g + ch.b), `RayMarch.glsl:306-309`."""
    return color.sum() / channels.sum()
