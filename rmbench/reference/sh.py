"""Real spherical harmonics (bands l <= 3, 16 terms) for the SH sky: the
port of the JAX package's `core/sh.py`.

An SH sky is 16 multiply-adds per channel per direction (no gather), and
its gradient with respect to the coefficients is the basis itself.  The
RGB megakernel evaluates the same sum in-kernel
(`csrc/mega_paths.cu` `sh_eval`), with the same float32 constants and the
same order of terms.  Basis: the standard real SH with the graphics
convention's constants (no Condon-Shortley phase).
"""
from __future__ import annotations

import numpy as np
import torch

from rmbench.reference.vecmath import Vec3

N_SH = 16  # bands 0..3


def sh_basis(d: Vec3):
    """The 16 l <= 3 real-SH basis functions at unit direction(s) `d`, a
    list of tensors shaped like d.x."""
    x, y, z = d.x, d.y, d.z
    return [
        0.282095 * torch.ones_like(x),
        0.488603 * y,
        0.488603 * z,
        0.488603 * x,
        1.092548 * x * y,
        1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
        0.590044 * y * (3.0 * x * x - y * y),
        2.890611 * x * y * z,
        0.457046 * y * (5.0 * z * z - 1.0),
        0.373176 * z * (5.0 * z * z - 3.0),
        0.457046 * x * (5.0 * z * z - 1.0),
        1.445306 * z * (x * x - y * y),
        0.590044 * x * (x * x - 3.0 * y * y),
    ]


def sh_eval(coeffs, d: Vec3) -> Vec3:
    """Radiance of an SH sky: `coeffs` (16, 3) -> RGB at `d`, clamped at 0
    (an SH expansion of a non-negative map can ring negative)."""
    basis = sh_basis(d)
    r = g = b = torch.zeros_like(d.x)
    for k, bk in enumerate(basis):
        r = r + bk * coeffs[k, 0]
        g = g + bk * coeffs[k, 1]
        b = b + bk * coeffs[k, 2]
    return Vec3(torch.clamp(r, min=0.0), torch.clamp(g, min=0.0),
                torch.clamp(b, min=0.0))


def constant_coeffs(value: float) -> np.ndarray:
    """SH coefficients of a constant sky of the given radiance."""
    c = np.zeros((N_SH, 3), np.float32)
    c[0, :] = value / 0.282095
    return c


def latlong_dirs(h: int, w: int, device="cuda") -> Vec3:
    """Unit directions of an (h, w) equirect grid in the `Scene.sky`
    texture convention (u = phi / 2 pi with phi = atan2(z, x) wrapped to
    [0, 2 pi); v = 1 - (y * 0.5 + 0.5); texel centres at half-integers),
    computed in float64 and rounded to float32 as in the JAX package."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    y = 1.0 - 2.0 * v
    phi = u * 2.0 * np.pi
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    x = np.cos(phi)[None, :] * sin_t[:, None]
    z = np.sin(phi)[None, :] * sin_t[:, None]
    yy = np.broadcast_to(y[:, None], (h, w))
    return Vec3(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                  for a in (x, yy, z)))


def bake_latlong(coeffs, h: int = 64, w: int = 128,
                 device="cuda") -> np.ndarray:
    """SH coefficients rendered on `device` to an (h, w, 3) linear latlong
    texture (loadable back as an env image)."""
    coeffs = torch.as_tensor(np.asarray(coeffs, np.float32), device=device)
    c = sh_eval(coeffs, latlong_dirs(h, w, device))
    return torch.stack([c.x, c.y, c.z], dim=-1).cpu().numpy()
