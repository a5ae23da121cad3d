"""The CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA card (`requires_cuda`) and skips without one.
No JAX: on the machine with the card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX).  The bar is the
one the JAX package sets for its own kernel: fewer than 1e-3 of the values
off by more than 1e-5.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (ALL_NODES_SCENE, MAX_FRAC_OFF, cuda_device,  # noqa: F401
                           frac_off)

from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.kernels import march
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.mega import trace_mega_spectral
from raymarchrenderer_tpu_torch.render.raygen import pixel_grid
from raymarchrenderer_tpu_torch.render.spectral_integrator import band_table
from raymarchrenderer_tpu_torch.scene import builtin, loads_scene

_STRICT = dict(relax=0.0, taps=6, lazy_miss=False, march_unroll=4,
               regen_cadence=0)
_PRODUCTION = dict(relax=2.0, taps=4, lazy_miss=True, march_unroll=32,
                   regen_cadence=16)


def _scene(name):
    return (builtin.sphere_on_floor() if name == "demo"
            else loads_scene(ALL_NODES_SCENE))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("scene_name", ["demo", "all_nodes"])
@pytest.mark.parametrize("knobs", [_STRICT, _PRODUCTION],
                         ids=["strict", "production"])
def test_kernel_matches_plain(cuda_device, scene_name, knobs):
    """Kernel vs plain version on the same CUDA tensors, on a patch at a
    non-zero origin; the launch counter rises by exactly one."""
    scene = _scene(scene_name)
    params = scene.init_params(cuda_device)
    mats = band_table(scene, cuda_device)
    cfg = RenderConfig(width=96, height=64, max_steps=192, max_bounces=4,
                       max_dist=100.0, relax_omega=knobs["relax"],
                       normal_taps=knobs["taps"])
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        cuda_device)
    sched = {k: knobs[k] for k in ("lazy_miss", "march_unroll",
                                   "regen_cadence")}
    launches = march.MEGA_SPECTRAL.launches
    got = march.render_fused_spectral(scene, params, mats, cfg, corners, 2,
                                      n_samples=3, origin_xy=(8, 4),
                                      patch_shape=(48, 80), **sched)
    torch.cuda.synchronize()
    assert march.MEGA_SPECTRAL.launches == launches + 1
    assert got.shape == (48, 80, 3) and got.device == corners.device
    px, py = pixel_grid(80, 48, cuda_device, (8, 4))
    plain = trace_mega_spectral(scene, params, mats, cfg, corners, px, py, 2,
                                n_samples=3, **sched).stack(-1)
    plain = plain * float(np.float32(1.0 / 3.0))
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0.0
    assert frac_off(plain.cpu().numpy(), got.cpu().numpy()) < MAX_FRAC_OFF


@pytest.mark.requires_cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    scene = builtin.sphere_on_floor()
    cfg = RenderConfig(width=16, height=16, max_steps=32, max_bounces=2)
    corners = Camera().corner_rays_flat(cuda_device)
    with pytest.raises(ValueError, match="different devices"):
        march.render_fused_spectral(scene, scene.init_params("cpu"),
                                    band_table(scene, cuda_device), cfg,
                                    corners, 0)
