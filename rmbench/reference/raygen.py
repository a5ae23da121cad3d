"""Primary ray generation: pixel grid -> jittered ray directions.

Bilinear corner-ray interpolation with sub-pixel jitter
(`RayMarch3.glsl:534-535`): f = (pix + jitter) / size,
dir = normalize(bilerp(corners, fx, fy)), fx sweeping ray00 -> ray10 and fy
the rows (row 0 = image top).  `corners` is the (5, 3) float32 tensor of
`Camera.corner_rays_flat`.
"""
from __future__ import annotations

import torch

from rmbench.reference.rng import RNGStream
from rmbench.reference.vecmath import Vec3, div, vlerp


def pixel_grid(width: int, height: int, device, origin_xy=(0, 0)):
    """int32 (px, py) tensors of shape (height, width) at `origin_xy`;
    px runs along dim 1, py along dim 0 (row 0 = top)."""
    ox, oy = origin_xy
    py, px = torch.meshgrid(
        torch.arange(oy, oy + height, dtype=torch.int32, device=device),
        torch.arange(ox, ox + width, dtype=torch.int32, device=device),
        indexing="ij")
    return px, py


def _corner(corners, k: int) -> Vec3:
    return Vec3(corners[k, 0], corners[k, 1], corners[k, 2])


def primary_rays(corners, px, py, width: int, height: int,
                 rng: RNGStream) -> Vec3:
    """Jittered, normalized primary directions for integer pixel coords."""
    r00, r10, r01, r11 = (_corner(corners, k) for k in range(1, 5))
    ux = rng.next()
    uy = rng.next()
    fx = div(px.to(torch.float32) + ux, width)
    fy = div(py.to(torch.float32) + uy, height)
    d = vlerp(vlerp(r00, r10, fx), vlerp(r01, r11, fx), fy)
    return d.normalized()


def eye_vec(corners) -> Vec3:
    return _corner(corners, 0)
