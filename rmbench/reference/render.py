"""The reference's entry points: chosen pixels of a render, worked out
again from the scene's text, the configuration and the camera corners.

Every random draw of the megakernel schedules is keyed on (seed, pixel,
sample, bounce), and a kernel lane's result for one path depends only on
where the path starts on the schedule's step grid: the first sample of a
launch takes the peeled first step, every later one starts at a pass
boundary (`mega._peeled_step`).  So each (pixel, sample) pair is one lane
here, a launch's samples of one pixel are summed in sample order and
scaled by float32(1/n) as a kernel lane does, and any set of pixels of
any frame can be checked at a few hundred thousand lanes.
"""
from __future__ import annotations

import numpy as np
import torch

from rmbench.reference.bands import band_table
from rmbench.reference.camera import Camera
from rmbench.reference.config import RenderConfig
from rmbench.reference.graph import loads_scene
from rmbench.reference.mega import trace_mega_paths, trace_mega_spectral

# the production schedule knobs of every launch (32 march steps a shade
# pass, a miss-retire pass every 16, the lazy miss test, a pass every
# body)
KNOBS = dict(march_unroll=32, lazy_miss=True, regen_cadence=16,
             shade_gate=0.0)


class Reference:
    """One configuration's scene, as the reference parses it, on
    `device`: `path` is "spectral" (the gen-3 spectral transport with the
    scene's band table) or "rgb" (the gen-1 RGB transport, with NEE when
    `direct_light`)."""

    def __init__(self, scene_text: str, cfg: RenderConfig, path: str,
                 direct_light: bool, device):
        if path not in ("spectral", "rgb"):
            raise ValueError(f"path must be 'spectral' or 'rgb', not {path!r}")
        self.scene = loads_scene(scene_text)
        self.params = self.scene.init_params(device)
        self.mats = (band_table(self.scene, device) if path == "spectral"
                     else None)
        self.cfg = cfg
        self.path = path
        self.direct_light = direct_light
        self.device = torch.device(device)

    def lanes(self, corners, px, py, sample, peel, work=None):
        """The (N, 3) sums of one path per lane: pixel (px, py), sample
        index `sample` (int64), `peel` true where the path is a launch's
        first sample; `work` gains the schedule's "march" and "shade"
        counts."""
        if self.path == "spectral":
            c = trace_mega_spectral(self.scene, self.params, self.mats,
                                    self.cfg, corners, px, py, sample,
                                    n_samples=1, work=work, peel=peel,
                                    **KNOBS)
        else:
            c = trace_mega_paths(self.scene, self.params, self.cfg, corners,
                                 px, py, sample, n_samples=1,
                                 direct_light=self.direct_light, work=work,
                                 peel=peel, **KNOBS)
        return torch.stack(tuple(c), dim=-1)

    def launch_pixels(self, corners, px, py, sample0, n_samples: int,
                      work=None):
        """(N, 3): what one launch of `n_samples` samples from `sample0[j]`
        renders at pixel (px[j], py[j]), the mean over its samples."""
        dev = self.device
        n = px.numel()
        sid = torch.arange(n_samples, dtype=torch.int64, device=dev)[:, None]
        sid = sid.expand(n_samples, n)
        fx = px.to(dev, torch.int32)[None].expand(n_samples, n).contiguous()
        fy = py.to(dev, torch.int32)[None].expand(n_samples, n).contiguous()
        sample = sample0.to(dev, torch.int64)[None] + sid
        c = self.lanes(corners, fx, fy, sample, sid == 0, work)
        total = c[0]
        for s in range(1, n_samples):
            total = total + c[s]
        return total * float(np.float32(1.0 / n_samples))

    def running_means(self, corners, px, py, n_passes: int, work=None):
        """(n_passes, N, 3): the progressive preview's accumulator at pixel
        (px[j], py[j]) after each of `n_passes` one-sample passes (pass p
        draws sample p), merged as new = (old * n + tile * k) / (n + k)
        with k = 1."""
        dev = self.device
        n = px.numel()
        sid = torch.arange(n_passes, dtype=torch.int64, device=dev)[:, None]
        sid = sid.expand(n_passes, n)
        fx = px.to(dev, torch.int32)[None].expand(n_passes, n).contiguous()
        fy = py.to(dev, torch.int32)[None].expand(n_passes, n).contiguous()
        c = self.lanes(corners, fx, fy, sid, None, work)
        acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        out = torch.empty((n_passes, n, 3), dtype=torch.float32, device=dev)
        for p in range(n_passes):
            acc = (acc * float(p) + c[p] * 1.0) / (float(p) + 1.0)
            out[p] = acc
        return out


def corners(cfg: RenderConfig, device) -> torch.Tensor:
    """The (5, 3) camera tensor of the reference's default view
    (`Program.cpp:102`) at the frame's aspect: the input both sides get."""
    return Camera(aspect=cfg.width / cfg.height).corner_rays_flat(device)
