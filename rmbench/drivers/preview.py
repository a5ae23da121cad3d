"""The interactive preview (`samples == 0`, `Program.cpp:184-236`): a
closed loop of `render.tiles.ProgressiveRenderer.endless_passes(1)` on
the configuration's tile grid, each pass one sample of every tile in
spiral order, each tile one launch merged into the running mean; a pass
ends when its accumulator is ready on the device, as a viewer would
show it.  The warm-up is one pass.

Traffic parameters: `check_pixels`, the pixels the check compares.

`pass_p95_ms`: the 95th percentile of the wall time of every pass in
the window (numpy's linear interpolation), the count beside it in
`attempted`.  Each call of `endless_passes(1)` runs inside the harness
span `rmbench.driver_host`, which the traced run's readers find.

After every pass (warm-up and window), once its time is taken, the
accumulator's values at pixels drawn from the seed are gathered (one
small gather on the device); the check holds each pass's to the
reference's running mean after the same number of passes.  Number:
`worst_pass_off_share`, the largest share of one pass's values off.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from rmbench import harness
from rmbench.check import bf16_control, load_limits, off_mask
from rmbench.program import Program, sync
from rmbench.reference.render import corners

DRIVER_SPAN = "rmbench.driver_host"


def setup(run) -> None:
    from raymarchrenderer_tpu_torch.render.tiles import ProgressiveRenderer
    prog = Program(run)
    prog.prepare()
    run.prog = prog
    run.renderer = ProgressiveRenderer(prog.scene, prog.params, prog.cfg,
                                       prog.corners, impl="fused",
                                       direct_light=prog.direct_light)
    cfg = prog.cfg
    run.pixels = torch.as_tensor(
        harness.pick_pixels(run.seed, cfg.width * cfg.height,
                            int(run.traffic["check_pixels"])),
        dtype=torch.int64, device=run.device)
    run.values = []          # per pass: (N, 3) accumulator at run.pixels


def _gather(run) -> None:
    run.values.append(
        run.renderer.accum.reshape(-1, 3).index_select(0, run.pixels))


def warm(run) -> None:
    run.renderer.endless_passes(1)
    _gather(run)
    sync(run.device)


def window(run, seconds: float) -> None:
    times = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        with torch.profiler.record_function(DRIVER_SPAN):
            run.renderer.endless_passes(1)
        sync(run.device)
        c = time.perf_counter()
        times.append(c - a)
        _gather(run)
        if c - t0 >= seconds:
            break
    sync(run.device)
    run.window_s = time.perf_counter() - t0
    run.attempted = len(times)
    run.e2e["pass_p95_ms"] = float(np.percentile(times, 95)) * 1e3


def check(run, control: bool = False) -> None:
    """Hold every pass's accumulator at the checked pixels to the
    reference's running mean after as many passes; `control` puts the
    reference at bfloat16 in the program's place."""
    cfg = run.prog.cfg
    got = torch.stack(run.values)                    # (P, N, 3)
    run.values = None
    ref = run.prog.reference(run)
    run.renderer = run.prog = None
    px = (run.pixels % cfg.width).to(torch.int32)
    py = (run.pixels // cfg.width).to(torch.int32)
    with torch.no_grad():
        cam = corners(ref.cfg, run.device)
        want = ref.running_means(cam, px, py, got.shape[0])
        if control:
            with bf16_control():
                got = ref.running_means(cam, px, py, got.shape[0])
    share = off_mask(got, want).float().mean(dim=(1, 2))   # per pass
    run.readings = {"worst_pass_off_share": float(share.max())}
    limit = load_limits(run.workload, run.spec.root)["worst_pass_off_share"]
    run.failed = min(int((share > limit).sum()), run.attempted)
