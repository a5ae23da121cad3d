"""The system under test, as the drivers build it: the port's own scene
parser, parameters, band table and kernels, on the run's device.  The
camera corners are the benchmark's input (`reference.render.corners`),
handed to the program and to the reference alike."""
from __future__ import annotations

import torch


class Program:
    """One configuration in the port: `cfg`, `scene`, `params`, `mats`
    (the band table of the spectral path, else None) and `corners`;
    `overrides` replaces render settings (a train job's)."""

    def __init__(self, run, overrides=None):
        from raymarchrenderer_tpu_torch.render.config import RenderConfig
        from raymarchrenderer_tpu_torch.render.spectral_integrator import (
            band_table)
        from raymarchrenderer_tpu_torch.scene.graph import loads_scene
        from rmbench.reference import render as ref_render
        from rmbench.reference.config import RenderConfig as RefConfig

        self.path = run.config["path"]
        self.direct_light = bool(run.config["direct_light"])
        settings = run.render_settings(overrides)
        self.cfg = RenderConfig(**settings)
        self.ref_cfg = RefConfig(**settings)
        self.device = run.device
        self.scene = loads_scene(run.scene_text())
        self.params = self.scene.init_params(run.device)
        self.mats = (band_table(self.scene, run.device)
                     if self.path == "spectral" else None)
        self.corners = ref_render.corners(self.ref_cfg, run.device)

    def kernel(self):
        """The render megakernel of the configuration's path."""
        from raymarchrenderer_tpu_torch.kernels import march
        return march.MEGA_SPECTRAL if self.path == "spectral" \
            else march.MEGA_PATHS

    def prepare(self) -> None:
        """Build and load the path's kernel ahead of its first launch
        (nothing on the CPU)."""
        from raymarchrenderer_tpu_torch.kernels import march
        march.prepare(self.device, self.kernel())

    def frame(self, sample0: int, n_samples: int) -> torch.Tensor:
        """One full-frame launch: the (H, W, 3) mean over `n_samples`
        samples from `sample0`."""
        from raymarchrenderer_tpu_torch.kernels import march
        if self.path == "spectral":
            return march.render_fused_spectral(
                self.scene, self.params, self.mats, self.cfg, self.corners,
                sample0, n_samples=n_samples)
        return march.render_fused(
            self.scene, self.params, self.cfg, self.corners, sample0,
            n_samples=n_samples, direct_light=self.direct_light)

    def reference(self, run):
        """The configuration in the benchmark's plain reference, on the
        run's device."""
        from rmbench.reference.render import Reference
        return Reference(run.scene_text(), self.ref_cfg, self.path,
                         self.direct_light, run.device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
