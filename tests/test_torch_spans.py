"""The port's profiler spans (`utils.profiling.span`) and the benchmark's
readers of them.

On the CPU, under `torch.profiler.profile(activities=[CPU])`: a pass of
the progressive driver opens `rmr.pass`, each scene-buffer build
`rmr.scene_buffers`, the first on a scene with `rmr.scene_compile` inside
it (the layout's compile, once per scene and device), and a recorded
train step `rmr.forward` (with `rmr.record` inside it), then
`rmr.backward`, then `rmr.update`; a ctypes launch opens a span named
after its entry point, and an RGB megakernel launch on the pixel queue
opens `rmr.pixel_queue` around it.  With no profiler, `span` hands back
one shared no-op context manager.

The eleven per-layer readers of these spans (`rmbench/metrics/`, loaded
by path as the harness loads them) are held to values worked out by hand
on a small synthetic Chrome trace, with a backward launch on a second
thread and a recorder span nested in a forward span, and read None on a
trace without the program's spans, as a parent commit's is."""
from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rmbench import harness
from rmbench.trace import Trace
from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.scene import builtin
from raymarchrenderer_tpu_torch.utils.profiling import span

TINY = dict(width=8, height=4, max_steps=16, max_bounces=1, max_dist=100.0)


def _spans(prof, prefix="rmr"):
    """[(name, start us, end us)] of the profiler's events whose name
    starts with `prefix`, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _corners():
    return Camera(aspect=TINY["width"] / TINY["height"]).corner_rays_flat(
        "cpu")


# -- the span helper ----------------------------------------------------------

def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("rmr.pass"), span("rmr.forward")
    assert a is b
    with a as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert _spans(prof) == []


def test_span_under_a_profiler_records_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("rmr.pass"):
            with span("rmr.scene_buffers"):
                torch.ones(4).sum()
    got = _spans(prof)
    assert [s[0] for s in got] == ["rmr.pass", "rmr.scene_buffers"]
    assert _inside(got[1], got[0])


def test_a_kernel_launch_opens_a_span_named_after_its_entry():
    from raymarchrenderer_tpu_torch.kernels.build import CudaKernel
    k = CudaKernel("mega_paths.cu", "rmr_test_entry", [])
    k._fn = lambda *args: 0             # the ctypes entry's stand-in
    k.launch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        k.launch()
    assert [s[0] for s in _spans(prof)] == ["rmr_test_entry"]
    assert k.launches == 2
    k._fn = lambda *args: 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k.launch()
    assert k.launches == 2


# -- the spans in the program -------------------------------------------------

def test_endless_passes_open_one_pass_span_each():
    from raymarchrenderer_tpu_torch.render.tiles import ProgressiveRenderer
    scene = builtin.sphere_on_floor()
    cfg = RenderConfig(grid_width=2, grid_height=2, **TINY)
    renderer = ProgressiveRenderer(scene, scene.init_params("cpu"), cfg,
                                   _corners())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        renderer.endless_passes(2)
        renderer.render_pass(spp=1)
    assert [s[0] for s in _spans(prof, "rmr.pass")] == ["rmr.pass"] * 3
    assert renderer.pass_n == 1.0


@pytest.mark.parametrize("n_samples, queued", [(1, True), (128, False)])
def test_a_queued_launch_opens_the_pixel_queue_span(n_samples, queued,
                                                    monkeypatch):
    """`rmr_mega_paths` at one sample a pixel gets a queue counter and runs
    inside `rmr.pixel_queue`; at 128 it gets a null counter and no such
    span.  The entry point is a stand-in: no card here."""
    from raymarchrenderer_tpu_torch.kernels import march
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    seen = []
    monkeypatch.setattr(march.MEGA_PATHS, "_fn",
                        lambda *args: seen.append(args) or 0)
    monkeypatch.setattr(march, "scene_dims",
                        lambda dims, device, exact: march.SceneDims(*dims))
    monkeypatch.setattr(march, "stream_args", lambda device: (0, 0))
    scene = builtin.csg_demo()
    cfg = RenderConfig(**TINY)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        march._launch_mega_paths(scene, scene.init_params("cpu"), cfg,
                                 _corners(), (0, 0), 4, 8, 0, n_samples,
                                 True, 32, True, True, 16)
    queue = seen[0][7]
    assert (queue is not None) == queued
    got = [s for s in _spans(prof) if s[0] in ("rmr.pixel_queue",
                                               "rmr_mega_paths")]
    assert [s[0] for s in got] == (["rmr.pixel_queue", "rmr_mega_paths"]
                                   if queued else ["rmr_mega_paths"])
    if queued:
        assert _inside(got[1], got[0])


def _paths(scene_fn):
    from raymarchrenderer_tpu_torch.kernels.scene_program import paths_buffers
    scene = scene_fn()
    return lambda: paths_buffers(scene, scene.init_params("cpu"), "cpu")


def _spectral():
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        spectral_buffers)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    scene, params, mats = spectral_demo("cpu")
    return lambda: spectral_buffers(scene, params, mats, "cpu")


def _objects():
    from raymarchrenderer_tpu_torch.kernels.scene_program import (
        object_buffers)
    scene = builtin.sphere_on_floor()
    return lambda: object_buffers(scene, scene.init_params("cpu"), "cpu")


@pytest.mark.parametrize("build", ["paths_csg", "paths_sof", "spectral",
                                   "objects"])
def test_scene_buffers_span_holds_the_compile_span(build):
    """The first build on a freshly parsed scene compiles its layout in
    `rmr.scene_compile` inside `rmr.scene_buffers`; the second build on
    that scene opens `rmr.scene_buffers` alone, with the same words and
    floats."""
    make = {"paths_csg": lambda: _paths(builtin.csg_demo),
            "paths_sof": lambda: _paths(builtin.sphere_on_floor),
            "spectral": _spectral, "objects": _objects}[build]
    want = make()()
    fn = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = fn()
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["rmr.scene_buffers",
                                     "rmr.scene_compile"]
    assert _inside(spans[1], spans[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        second = fn()
    assert [s[0] for s in _spans(prof)] == ["rmr.scene_buffers"]
    # both are the buffers of another scene's build without a profiler,
    # word for word
    for got in (first, second):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[2] == want[2]


def _order_of_phases(prof):
    """The train step's phase spans, in start order, with the recorder's
    checked to lie inside the forward's."""
    phases = [s for s in _spans(prof, "rmr.")
              if s[0] in ("rmr.forward", "rmr.record", "rmr.backward",
                          "rmr.update")]
    fwd = next(s for s in phases if s[0] == "rmr.forward")
    rec = next(s for s in phases if s[0] == "rmr.record")
    assert _inside(rec, fwd)
    return [s[0] for s in phases]


def test_spectral_train_step_spans_in_order():
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        spectral_update, train_grads_spectral_sharded)
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        spectral_demo)
    scene, params, mats = spectral_demo("cpu")
    cfg = RenderConfig(**TINY)
    target = torch.full((4, 8, 3), 0.2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, grads, band_grads = train_grads_spectral_sharded(
            scene, params, mats, cfg, _corners(), target, 1,
            march_impl="recorded", sample0=3)
        spectral_update(params, mats, grads, band_grads, 1e-2)
    assert _order_of_phases(prof) == ["rmr.forward", "rmr.record",
                                      "rmr.backward", "rmr.update"]
    assert torch.isfinite(loss)


def test_rgb_train_step_spans_in_order():
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        sgd, train_grads_sharded)
    scene = builtin.sphere_on_floor()
    params = scene.init_params("cpu")
    cfg = RenderConfig(**TINY)
    target = torch.full((4, 8, 3), 0.2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, grads = train_grads_sharded(scene, params, cfg, _corners(),
                                          target, 1, march_impl="recorded")
        sgd(params, grads, 1e-2)
    assert _order_of_phases(prof) == ["rmr.forward", "rmr.record",
                                      "rmr.backward", "rmr.update"]
    assert torch.isfinite(loss)


# -- the readers on a synthetic trace -----------------------------------------

def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 5, tid, corr)


def _on_card(ts, dur, corr, cat="kernel", name="k"):
    return _x(name, cat, ts, dur, tid=7, corr=corr)


HARNESS_EVENTS = [
    _x("rmbench.window", "user_annotation", 0, 100000),
    # preview: the harness's span, its copies and waits
    _x("rmbench.driver_host", "user_annotation", 990, 1020),
    _x("rmbench.driver_host", "user_annotation", 2990, 620),
    _x("cudaMemcpyAsync", "cuda_runtime", 1150, 50),
    _x("cudaStreamSynchronize", "cuda_runtime", 1200, 100),
    _launch(1405, 50),
    _x("cudaStreamSynchronize", "cuda_runtime", 1500, 200),
    _x("cudaMemcpyAsync", "cuda_runtime", 2500, 100),   # between passes
    _x("cudaMemcpyAsync", "cuda_runtime", 3120, 20),
    _x("cudaMemcpyAsync", "cuda_runtime", 3150, 100),
    _launch(3302, 51),
    # train step 1: recorder, forward, backward on autograd's thread
    _launch(10200, 101),
    _on_card(10210, 300, 101, name="record_spectral_kernel"),
    _launch(10600, 102),
    _on_card(10610, 40, 102),
    _launch(10700, 103, name="cudaMemcpyAsync"),
    _on_card(10710, 5, 103, cat="gpu_memcpy", name="Memcpy HtoD"),
    _launch(11000, 104),
    _on_card(11010, 60, 104),
    _launch(12500, 105, tid=2),
    _on_card(12510, 80, 105),
    _launch(12600, 106, tid=2, name="cudaMemsetAsync"),
    _on_card(12610, 3, 106, cat="gpu_memset", name="Memset"),
    _launch(13000, 107, tid=2),
    _on_card(13010, 70, 107),
    _launch(14100, 108),                # the update: neither phase
    _on_card(14110, 7, 108),
    # train step 2
    _launch(20100, 201),
    _on_card(20110, 300, 201, name="record_spectral_kernel"),
    _launch(20500, 202),
    _on_card(20510, 50, 202),
    _launch(21500, 203, tid=2),
    _on_card(21510, 90, 203),
    _on_card(30000, 11, 999),           # no runtime call of its own
]

PROGRAM_SPANS = [
    _x("rmr.pass", "user_annotation", 1000, 1000),
    _x("rmr.scene_buffers", "user_annotation", 1100, 300),
    _x("rmr.scene_compile", "user_annotation", 1300, 50),
    _x("rmr.pixel_queue", "user_annotation", 1395, 30),
    _x("rmr_mega_paths", "user_annotation", 1400, 20),
    _x("rmr.pass", "user_annotation", 3000, 600),
    _x("rmr.scene_buffers", "user_annotation", 3100, 200),
    _x("rmr_mega_paths", "user_annotation", 3300, 10),
    _x("rmr.forward", "user_annotation", 10000, 2000),
    _x("rmr.record", "user_annotation", 10100, 400),
    _x("rmr.backward", "user_annotation", 12000, 2000),
    _x("rmr.update", "user_annotation", 14000, 500),
    _x("rmr.forward", "user_annotation", 20000, 1000),
    _x("rmr.record", "user_annotation", 20050, 250),
    _x("rmr.backward", "user_annotation", 21000, 1000),
]

# worked out by hand (times in us):
#   passes 1000 + 600 us, waits inside them (1150-1300, 1500-1700;
#   3120-3140, 3150-3250) 350 + 120: (1600 - 470) / 2 passes;
#   scene buffers 300 + 200 us, waits inside 150 + 120;
#   copies started inside the scene buffers 1 + 2, over 2 launches;
#   launches 1 + 1 inside the 2 passes, the first of the 2 inside the
#   pixel queue's span;
#   forward (outside the recorder) 40 + 5 + 60 + 50 us, backward
#   80 + 3 + 70 + 90 us, over 2 steps; kernels 102, 104, 202 and 105,
#   107, 203.
EXPECTED = {
    "pass_host_ms.preview": 1130 / 2 * 1e-3,
    "scene_buffers_host_ms.preview": (500 - 270) / 2 * 1e-3,
    "scene_upload_wait_ms.preview": 270 / 2 * 1e-3,
    "h2d_copies_per_launch.preview": 3 / 2,
    "launches_per_pass.preview": 2 / 2,
    "queued_launch_share.mega_paths": 1 / 2,
    "queued_launch_share.frames": 1 / 2,
    "forward_device_ms.train": 155 / 2 * 1e-3,
    "backward_device_ms.train": 243 / 2 * 1e-3,
    "forward_launches_per_step.train": 3 / 2,
    "backward_launches_per_step.train": 3 / 2,
}


def _run(tmp_path, events, attempted=2):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    run = type("Run", (), {})()
    run.tr, run.attempted = Trace(path), attempted
    return run


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_synthetic_trace(metric, tmp_path):
    run = _run(tmp_path, HARNESS_EVENTS + PROGRAM_SPANS)
    got = harness.Spec().reader(metric).read(run)
    assert got == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_none_without_the_programs_spans(metric, tmp_path):
    run = _run(tmp_path, HARNESS_EVENTS)
    assert harness.Spec().reader(metric).read(run) is None


def test_pass_host_agrees_with_the_harness_span_rule(tmp_path):
    """The pass spans and the harness's spans around them, 20 us longer
    each, read the same host time but for those microseconds."""
    run = _run(tmp_path, HARNESS_EVENTS + PROGRAM_SPANS)
    spec = harness.Spec()
    outer = spec.reader("driver_host_ms.preview").read(run)
    inner = spec.reader("pass_host_ms.preview").read(run)
    assert outer - inner == pytest.approx(20e-3, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_benchmark_declares_each_reader(metric):
    spec = harness.Spec()
    entry = next(m for m in spec.doc["per_layer"] if m["name"] == metric)
    cell = entry["workloads"]
    assert entry["source"] == "device_trace" and len(cell) == 1
    assert metric in {m["name"] for m in spec.per_layer(cell[0])}
