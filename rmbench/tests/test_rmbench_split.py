"""The split cell on the CPU: a run of `spectral_sof_4k.split4` at a tiny
size through the port's plain versions on virtual positions (the one CPU
device repeated), its reference against the port's plain sharded render,
the check's verdict under the control and under three faults of the
merge planted here, and the readers of its per-layer metrics on a
synthetic trace.  The cell's faults are planted by this file's own
context managers; `rmbench.faults` has none for it."""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from rmbench import harness
from rmbench.reference import split
from rmbench.reference.config import RenderConfig as RefConfig
from rmbench.reference.render import Reference, corners

ROOT = Path(__file__).resolve().parent.parent
CELL = "spectral_sof_4k.split4"
TINY = dict(width=8, height=8, spp=4, max_steps=64, max_bounces=3)


def _cpu_run(seconds=0.6, control=False, check_pixels=24):
    torch.set_num_threads(2)
    run = harness.Run(harness.Spec(), CELL, 2**33 + 5, trace=False,
                      device=torch.device("cpu"), cfg_overrides=TINY,
                      traffic_overrides={"check_pixels": check_pixels})
    return harness.execute(run, seconds, time.perf_counter(), control)


def test_a_sound_cpu_run_reads_nought():
    result = _cpu_run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {k: c["value"] for k, c in result["checks"].items()} == {
        "off_share": 0.0, "worst_frame_off_share": 0.0,
        "worst_position_off_share": 0.0}
    assert result["device"]["count"] == 4
    assert "render_msamples_s" in result["metrics"]


def test_the_control_is_not_correct():
    assert not _cpu_run(control=True)["correct"]


@pytest.mark.parametrize("layout,spp", [((2, 2), 4), ((1, 2), 4),
                                        ((1, 2), 5)])
def test_the_reference_is_the_ports_sharded_render(layout, spp):
    """Every pixel of an 8 x 6 frame at sample0 = 2 * spp (a frame of the
    progressive sequence), the remainder's extra sample included at 5
    spp: bit for bit."""
    from raymarchrenderer_tpu_torch.parallel import sharding
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        band_table)
    from raymarchrenderer_tpu_torch.scene.graph import loads_scene
    conf = json.loads((ROOT / "configs" / "spectral_sof_4k.json")
                      .read_text())
    text = (ROOT / "configs" / conf["scene"]).read_text()
    settings = dict(conf["render"], width=8, height=6, spp=spp,
                    max_steps=64, max_bounces=3, seed=77)
    ref = Reference(text, RefConfig(**settings), "spectral", False, "cpu")
    cam = corners(ref.cfg, "cpu")
    scene = loads_scene(text)
    mesh = sharding.make_mesh(sharding.ShardConfig(*layout),
                              [torch.device("cpu")] * 4)
    got = sharding.render_sharded_spectral(
        scene, scene.init_params("cpu"), band_table(scene, "cpu"),
        RenderConfig(**settings), cam, spp, mesh=mesh, sample0=2 * spp)
    idx = torch.arange(48)
    want = split.merged_pixels(ref, cam, (idx % 8).to(torch.int32),
                               (idx // 8).to(torch.int32),
                               torch.full((48,), 2 * spp), spp, layout[1])
    assert torch.equal(got.reshape(-1, 3), want)


@contextlib.contextmanager
def _merge_patched(fn):
    """`parallel.sharding._merge` sees the parts as `fn(parts)` gives
    them."""
    from raymarchrenderer_tpu_torch.parallel import sharding
    merge = sharding._merge
    sharding._merge = lambda parts, *a: merge(fn(parts), *a)
    try:
        yield
    finally:
        sharding._merge = merge


@contextlib.contextmanager
def _same_samples():
    """Every position's launch at its frame's first sample, so both
    sample slices render the same samples."""
    from raymarchrenderer_tpu_torch.kernels import march
    fused = march.render_fused_spectral

    def launch(scene, params, mats, cfg, corners, sample0, **kw):
        return fused(scene, params, mats, cfg, corners,
                     sample0 - sample0 % cfg.spp, **kw)

    march.render_fused_spectral = launch
    try:
        yield
    finally:
        march.render_fused_spectral = fused


FAULTS = {
    "slice_left_out": lambda: _merge_patched(
        lambda parts: {k: v for k, v in parts.items() if k[1] == 0}),
    "same_samples": _same_samples,
    "tiles_swapped": lambda: _merge_patched(
        lambda parts: {(1 - ti, si): v for (ti, si), v in parts.items()}),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_of_the_merge_are_not_correct(fault):
    """One spp slice left out of the merge, both slices at the same
    samples, the two tiles swapped."""
    with FAULTS[fault]():
        result = _cpu_run(check_pixels=32)
    assert not result["correct"], result["checks"]
    assert result["checks"]["worst_position_off_share"]["value"] > \
        result["checks"]["worst_position_off_share"]["limit"]


def test_a_run_loads_no_jax_and_no_jax_package():
    probe = (
        "import json, sys, time, torch\n"
        "from rmbench import harness\n"
        f"run = harness.Run(harness.Spec(), {CELL!r}, 11, trace=False, "
        f"device=torch.device('cpu'), cfg_overrides={TINY!r}, "
        "traffic_overrides={'check_pixels': 8})\n"
        "harness.execute(run, 0.2, time.perf_counter())\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    tops = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not tops & set(harness.FORBIDDEN), sorted(tops)
    assert "raymarchrenderer_tpu_torch" in tops


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _trace(tmp_path, merge=True):
    """Two frames over 4 cards in a 1000 us window: frame 0's kernels
    start at 10, 12, 20, 14 us and last 300, 280, 290, 310 us; frame 1's
    start at 510, 511, 512, 513 and last 300 each.  Each merge launches a
    copy of 5 us and an add of 3 us on card 0."""
    from rmbench.trace import Trace
    events = [_ev("rmbench.window", "user_annotation", 0, 1000)]
    corr = iter(range(1, 100))

    def launch(t, name, cat, dev, ts, dur):
        c = next(corr)
        events.append(_ev("cudaLaunchKernel", "cuda_runtime", t, 1,
                          correlation=c))
        events.append(_ev(name, cat, ts, dur, device=dev, correlation=c))

    for base, starts, durs in ((0, (10, 12, 20, 14), (300, 280, 290, 310)),
                               (500, (510, 511, 512, 513), (300,) * 4)):
        for dev, (s, d) in enumerate(zip(starts, durs)):
            launch(base + 1 + dev, "void mega_spectral_kernel<NoBanks>",
                   "kernel", dev, s, d)
        if merge:
            events.append(_ev("rmr.merge", "user_annotation", base + 10,
                              50))
        launch(base + 20, "Memcpy PtoP", "gpu_memcpy", 0, base + 330, 5)
        launch(base + 30, "add_kernel", "kernel", 0, base + 336, 3)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(path)


class _Run:
    def __init__(self, tr):
        self.tr = tr
        self.cell = {"chips": 4}
        self.attempted = 2
        self.work = {"march": 1e9, "shade": 1e8}
        self.config = {"render": {"normal_taps": 4, "width": 64,
                                  "height": 64}}
        conf = json.loads((ROOT / "configs" / "spectral_sof_4k.json")
                          .read_text())
        from rmbench.reference.graph import loads_scene
        self.ref_scene = loads_scene((ROOT / "configs" / conf["scene"])
                                     .read_text())


def _read(name, run):
    return harness.Spec().reader(name).read(run)


def test_the_split_metrics_read_a_trace(tmp_path):
    from rmbench import roofline
    run = _Run(_trace(tmp_path))
    assert _read("launch_skew_ms.split4", run) == pytest.approx(
        (10 + 3) / 2 * 1e-3)
    assert _read("card_imbalance_pct.split4", run) == pytest.approx(
        100.0 * 30 / 310 / 2)
    assert _read("merge_ms.split4", run) == pytest.approx(8e-3)
    busy = [300 + 8 + 300 + 8, 280 + 300, 290 + 300, 310 + 300]
    assert _read("device_idle_pct.split4", run) == pytest.approx(
        100.0 * sum(1 - b / 1000 for b in busy) / 4)
    least = roofline.bound_s(roofline.operations(
        run.ref_scene, 4, 1e9, 1e8), 64 * 64 * 12 + 60)[0] / 4
    # frame 0 from 10 to 339 us (its add ends last), frame 1 510 to 839
    assert _read("roofline_pct.split4", run) == pytest.approx(
        100.0 * least / 329e-6)


def test_the_split_metrics_fall_silent_without_the_merge_span(tmp_path):
    run = _Run(_trace(tmp_path, merge=False))
    for name in ("launch_skew_ms.split4", "card_imbalance_pct.split4",
                 "merge_ms.split4", "roofline_pct.split4"):
        assert _read(name, run) is None
