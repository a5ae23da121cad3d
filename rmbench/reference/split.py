"""The reference of a frame split over a (tile, spp) layout: what the
merged frame holds at chosen pixels.

Position (ti, si) renders its tile's rows over samples sample0 + si *
spp_per .. (spp_per = spp // n_spp) in one launch, and the positions si <
spp % n_spp one more launch of the one sample sample0 + n_spp * spp_per +
si; a launch's raw sum is its lanes' paths summed in sample order, its
first sample peeled (`render.Reference.lanes`).  The merge adds a pixel's
launches in si order and divides once by spp.  A pixel's value does not
depend on its tile: the tile axis only says which card renders it.
"""
from __future__ import annotations

import torch


def launches(spp: int, n_spp: int) -> list:
    """[(si, first sample's offset from sample0, count)] of every launch
    of a layout with `n_spp` sample slices, in the order the merge adds
    them."""
    spp_per, rem = divmod(int(spp), int(n_spp))
    out = []
    for si in range(n_spp):
        if spp_per:
            out.append((si, si * spp_per, spp_per))
        if si < rem:
            out.append((si, n_spp * spp_per + si, 1))
    return out


def merged_pixels(ref, corners, px, py, sample0, spp: int, n_spp: int,
                  work=None):
    """(N, 3): the merged frame of `spp` samples from `sample0[j]` at
    pixel (px[j], py[j]), over `n_spp` sample slices; `ref` is a
    `render.Reference`, `work` gains its schedule's counts.  Every launch
    of every pixel is one batch of lanes."""
    dev = ref.device
    n = px.numel()
    plan = launches(spp, n_spp)
    offset = torch.cat([torch.arange(o, o + k, dtype=torch.int64)
                        for _, o, k in plan]).to(dev)
    first = torch.cat([torch.arange(k) == 0 for _, _, k in plan]).to(dev)
    rows = offset.numel()
    fx = px.to(dev, torch.int32)[None].expand(rows, n).contiguous()
    fy = py.to(dev, torch.int32)[None].expand(rows, n).contiguous()
    sample = sample0.to(dev, torch.int64)[None] + offset[:, None]
    c = ref.lanes(corners, fx, fy, sample, first[:, None].expand(rows, n),
                  work)
    parts, row = {}, 0
    for si, _, k in plan:
        total = c[row]
        for s in range(1, k):
            total = total + c[row + s]
        row += k
        parts[si] = total if si not in parts else parts[si] + total
    merged = None
    for si in sorted(parts):
        merged = parts[si] if merged is None else merged + parts[si]
    return merged / float(spp)
