"""The benchmark's plain reference against the port's plain versions, on
the CPU at a tiny size: the reference's lanes of one path each give the
megakernel schedules' sums bit for bit, and its copied arithmetic is the
program's."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from rmbench import roofline
from rmbench.reference import graph as ref_graph
from rmbench.reference.config import RenderConfig as RefConfig
from rmbench.reference.render import Reference, corners

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TINY = dict(width=12, height=10, max_steps=96, max_bounces=6, seed=2**31 + 7)


def _config(name: str):
    doc = json.loads((CONFIGS / f"{name}.json").read_text())
    return doc, (CONFIGS / doc["scene"]).read_text()


def _settings(doc):
    return dict(doc["render"], **TINY)


def _port(doc, text):
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)
    from raymarchrenderer_tpu_torch.scene.graph import loads_scene
    cfg = RenderConfig(**_settings(doc))
    scene = loads_scene(text)
    mats = band_table(scene, "cpu") if doc["path"] == "spectral" else None
    return cfg, scene, scene.init_params("cpu"), mats


def _launch(doc, text, sample0, n):
    """The port's plain megakernel schedule over the whole tiny frame:
    (H, W, 3), the mean over `n` samples from `sample0`."""
    from raymarchrenderer_tpu_torch.kernels import march
    cfg, scene, params, mats = _port(doc, text)
    cam = corners(RefConfig(**_settings(doc)), "cpu")
    if doc["path"] == "spectral":
        return march.render_fused_spectral(scene, params, mats, cfg, cam,
                                           sample0, n_samples=n)
    return march.render_fused(scene, params, cfg, cam, sample0,
                              n_samples=n, direct_light=doc["direct_light"])


@pytest.mark.parametrize("name", ["spectral_sof", "rgb_csg_nee"])
def test_launch_pixels_equal_the_schedule_bit_for_bit(name):
    doc, text = _config(name)
    want = _launch(doc, text, 96, 3)
    cfg = RefConfig(**_settings(doc))
    ref = Reference(text, cfg, doc["path"], doc["direct_light"], "cpu")
    idx = torch.tensor([0, 5, 37, 60, 61, 99, 119])
    got = ref.launch_pixels(corners(cfg, "cpu"), idx % cfg.width,
                            idx // cfg.width, torch.full((7,), 96), 3)
    assert torch.equal(got, want.reshape(-1, 3)[idx])


def test_launch_pixels_take_each_pixel_its_own_first_sample():
    doc, text = _config("spectral_sof")
    a, b = _launch(doc, text, 0, 2), _launch(doc, text, 64, 2)
    cfg = RefConfig(**_settings(doc))
    ref = Reference(text, cfg, doc["path"], doc["direct_light"], "cpu")
    idx = torch.tensor([3, 50, 101])
    got = ref.launch_pixels(corners(cfg, "cpu"), idx % cfg.width,
                            idx // cfg.width, torch.tensor([0, 64, 0]), 2)
    want = torch.stack([a.reshape(-1, 3)[3], b.reshape(-1, 3)[50],
                        a.reshape(-1, 3)[101]])
    assert torch.equal(got, want)


def test_running_mean_equals_the_preview_accumulator():
    from raymarchrenderer_tpu_torch.render.tiles import ProgressiveRenderer
    doc, text = _config("rgb_csg_nee")
    settings = dict(_settings(doc), width=8, height=8)
    pcfg, scene, params, _ = _port(doc, text)
    pcfg = pcfg.replace(width=8, height=8)
    cfg = RefConfig(**settings)
    cam = corners(cfg, "cpu")
    r = ProgressiveRenderer(scene, params, pcfg, cam, impl="fused",
                            direct_light=True)
    passes = []
    r.endless_passes(3, callback=lambda p, acc: passes.append(
        acc.reshape(-1, 3).clone()))
    ref = Reference(text, cfg, "rgb", True, "cpu")
    idx = torch.arange(64)
    got = ref.running_means(cam, idx % 8, idx // 8, 3)
    assert torch.equal(got, torch.stack(passes))


@pytest.mark.parametrize("name", ["spectral_sof", "rgb_csg_nee"])
def test_copied_arithmetic_is_the_programs(name):
    from raymarchrenderer_tpu_torch.kernels import scene_program
    from raymarchrenderer_tpu_torch.scene.graph import loads_scene
    _, text = _config(name)
    assert roofline.NODE_FLOPS == scene_program.NODE_FLOPS
    assert roofline.map_flops(ref_graph.loads_scene(text)) \
        == scene_program.map_flops(loads_scene(text))


def test_bound_is_chip_smokes():
    """`operations` and `bound_s` are `chip_smoke._bound`'s arithmetic."""
    import chip_smoke
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.scene.graph import loads_scene
    _, text = _config("rgb_csg_nee")
    work = {"march": 123456789, "shade": 2345678}
    ms, by, ops = chip_smoke._bound(loads_scene(text),
                                    RenderConfig(normal_taps=4), work,
                                    1000, 12_000_000)
    mine = roofline.operations(ref_graph.loads_scene(text), 4,
                               work["march"], work["shade"])
    assert mine == ops
    assert roofline.bound_s(mine, 12_001_000) == (ms * 1e-3, by) or \
        abs(roofline.bound_s(mine, 12_001_000)[0] - ms * 1e-3) < 1e-15


def test_train_step_equals_the_ports_step():
    """One spectral train step (record, replay with the march adjoint,
    loss, gradients, update) against the port's, on the CPU."""
    from raymarchrenderer_tpu_torch.parallel import sharding
    from raymarchrenderer_tpu_torch.scene.graph import param_leaves
    from rmbench.reference import bands, train
    doc, text = _config("spectral_sof")
    settings = dict(doc["render"], width=8, height=8, max_steps=64,
                    max_bounces=3, relax_omega=1.9, seed=2**32 - 3)
    pcfg, scene, params, mats = _port(doc, text)
    pcfg = pcfg.replace(**{k: settings[k] for k in (
        "width", "height", "max_steps", "max_bounces", "relax_omega",
        "seed")})
    cfg = RefConfig(**settings)
    cam = corners(cfg, "cpu")
    target = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(3))
    loss, grads, band_grads = sharding.train_grads_spectral_sharded(
        scene, params, mats, pcfg, cam, target, 2, march_impl="recorded",
        sample0=4)
    p1, m1 = sharding.spectral_update(params, mats, grads, band_grads, 1e-2)
    rscene = ref_graph.loads_scene(text)
    rparams = rscene.init_params("cpu")
    rmats = bands.band_table(rscene, "cpu")
    rloss, rgrads, rband = train.loss_and_grads(rscene, rparams, rmats, cfg,
                                                cam, target, 2, 4)
    r1, rm1 = train.update(rparams, rmats, rgrads, rband, 1e-2)
    assert torch.equal(loss, rloss)
    for a, b in zip(param_leaves(p1), ref_graph.param_leaves(r1)):
        assert torch.equal(a, b)
    for a, b in zip(m1, rm1):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in rband)
