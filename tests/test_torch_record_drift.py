"""The RGB recorder's later-bounce t: how far the kernel, its plain
version on the card and its plain version on the CPU drift apart, and an
open fault of the banks' bar kept visible.

The banks' bar (tests/_torch_parity.py): decisions exact, bounce 0's t
within 1e-5, and fewer than 5% of the later bounces' both-hit t entries
(`LATER_FRAC_OFF`) off by more than 1e-4.  A later bounce starts from a
hit point and a direction through sin, cos and rsqrt, so two builds whose
functions differ by an ulp stop a grazing ray at another point of the
surface.  On sphere_on_floor's 37 x 53 patch at (11, 5) of a 96 x 64
frame (2 samples, 4 bounces, relax 1.9), on an NVIDIA H100 80GB HBM3:

    max_steps, seed        192, 0   192, 1   512, 0
    kernel vs card plain   5.25%    4.25%    5.23%
    kernel vs CPU plain    1.16%    0.65%    1.15%
    card vs CPU plain      5.43%    4.71%    5.40%

The plain version on the CPU against itself with sin and cos one ulp up
reads 1.07% and 1.11% at 192 steps.  So the kernel stays within an ulp's
drift of the CPU plain version, and the plain version's CUDA build is the
one that drifts past the bar; the kernel's banks are the same bytes as
before the render megakernels' redesign.  On
test_torch_cuda.py::test_record_kernel_matches_plain's patch the bar
holds against the card's plain version.

    PYTHONPATH=. python tests/test_torch_record_drift.py

prints, on the card, one JSON line per configuration: the kernel against
the plain version on the card and on the CPU, the two plain versions
against each other, and the SHA-256 of the kernel's banks (run it from
another checkout's root, with PYTHONPATH=., to read that tree's kernel).
Without a card it prints the plain version against itself with sin and
cos one ulp up.
"""
import hashlib
import json

import pytest
import torch

from _torch_parity import (LATER_FRAC_OFF, MAX_FRAC_OFF, bank_parity,
                           cuda_device)  # noqa: F401
from test_torch_uv_witness import _one_ulp_up

from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.kernels.record import (record_plain,
                                                       trace_record_fused)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.scene import builtin

# (max_steps, seed) of the readings; the first is the fault's
CASES = ((192, 0), (192, 1), (512, 0))
_ORIGIN, _SHAPE, _SAMPLES = (11, 5), (37, 53), 2


def record(device, steps, seed, kernel=False, moved=()):
    """The recorder's banks on sphere_on_floor's patch: the kernel's (a
    CUDA `device`) or the plain version's, with the torch functions
    `moved` one ulp up."""
    scene = builtin.sphere_on_floor()
    params = scene.init_params(device)
    cfg = RenderConfig(width=96, height=64, max_steps=steps, max_bounces=4,
                       relax_omega=1.9, seed=seed)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        device)
    fn = trace_record_fused if kernel else record_plain
    saved = {f: getattr(torch, f) for f in moved}
    try:
        for f in moved:
            setattr(torch, f, _one_ulp_up(saved[f]))
        return fn(scene, params, cfg, corners, _ORIGIN, _SHAPE, 0,
                  n_samples=_SAMPLES)
    finally:
        for f, orig in saved.items():
            setattr(torch, f, orig)


def _meets_bar(p):
    return (p["decisions"] < MAX_FRAC_OFF and p["t"] < MAX_FRAC_OFF
            and p["t_later"] < LATER_FRAC_OFF)


@pytest.mark.parametrize("steps, seed", CASES[:2])
def test_one_ulp_of_sin_cos_stays_inside_the_bar(steps, seed):
    """The plain version against itself with sin and cos one ulp up, on
    the CPU: the same decisions and bounce-0 t, and the later bounces'
    drift (about 1%) well inside the 5% bar."""
    want = record("cpu", steps, seed)
    got = record("cpu", steps, seed, moved=("sin", "cos"))
    p = bank_parity(got, want, 0)
    assert p["decisions"] == 0.0 and p["t"] == 0.0, p
    assert 0.0 < p["t_later"] < LATER_FRAC_OFF, p


@pytest.mark.requires_cuda
@pytest.mark.xfail(strict=True, reason=(
    "open fault: on this patch the plain recorder's CUDA build drifts from "
    "the kernel and from its CPU build past the later-bounce bar, 5.25% "
    "of the entries off by more than 1e-4 (PERF.md section 7)"))
def test_record_kernel_matches_card_plain_at_192_steps(cuda_device):
    """The recorder against its plain version on the card, at 192 steps,
    held to the banks' bar."""
    steps, seed = CASES[0]
    p = bank_parity(record(cuda_device, steps, seed, kernel=True),
                    record(cuda_device, steps, seed), 0)
    assert _meets_bar(p), p


@pytest.mark.requires_cuda
@pytest.mark.parametrize("steps, seed", CASES)
def test_record_kernel_matches_cpu_plain(cuda_device, steps, seed):
    """The recorder's banks against its plain version on the CPU, held to
    the banks' bar."""
    got = {k: v.cpu() for k, v in record(cuda_device, steps, seed,
                                         kernel=True).items()}
    p = bank_parity(got, record("cpu", steps, seed), 0)
    assert _meets_bar(p), p


def _digest(banks):
    h = hashlib.sha256()
    for k in sorted(banks):
        h.update(banks[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


if __name__ == "__main__":
    torch.set_num_threads(8)
    for steps, seed in CASES:
        cpu = record("cpu", steps, seed)
        line = {"max_steps": steps, "seed": seed}
        if torch.cuda.is_available():
            dev = torch.device("cuda", 0)
            kern = record(dev, steps, seed, kernel=True)
            card = record(dev, steps, seed)
            torch.cuda.synchronize()
            kern_cpu = {k: v.cpu() for k, v in kern.items()}
            card_cpu = {k: v.cpu() for k, v in card.items()}
            line.update({
                "card": torch.cuda.get_device_name(0),
                "kernel_vs_card_plain": bank_parity(kern, card, 0),
                "kernel_vs_cpu_plain": bank_parity(kern_cpu, cpu, 0),
                "card_plain_vs_cpu_plain": bank_parity(card_cpu, cpu, 0),
                "kernel_banks_sha256": _digest(kern)})
        else:
            line["cpu_plain_sin_cos_one_ulp_up"] = bank_parity(
                record("cpu", steps, seed, moved=("sin", "cos")), cpu, 0)
        print("record drift: " + json.dumps(line), flush=True)
