"""Closed loop of full-frame renders: frame k is one launch of the
path's megakernel over the whole frame at `spp` samples from sample
k * spp (the progressive sequence continued), and the next frame starts
when the last is ready on the device.  Frame 0 is the warm-up.

Traffic parameters: `check_pixels`, the pixels the check compares.

After each frame the values of the check's pixels are gathered from it
(one small gather on the device); once the window has closed every
checked pixel is given one frame, all frames as evenly as the count
allows, both drawn from the seed, and the reference works out that
pixel of that frame again.  Numbers: `off_share`, the share of the
values off, and `worst_frame_off_share`, the largest share of one
frame's values off.

`render_msamples_s`: the pixel-samples of every frame completed in the
window over the window's wall time; the window ends at the first frame
boundary after `--seconds`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from rmbench import harness
from rmbench.check import bf16_control, load_limits, off_mask
from rmbench.program import Program, sync
from rmbench.reference.render import corners


def setup(run) -> None:
    prog = Program(run)
    prog.prepare()
    cfg = prog.cfg
    run.prog = prog
    run.spp = cfg.spp
    run.pixels = torch.as_tensor(
        harness.pick_pixels(run.seed, cfg.width * cfg.height,
                            int(run.traffic["check_pixels"])),
        dtype=torch.int64, device=run.device)
    run.values = []          # per frame: (N, 3) values at run.pixels


def _frame(run, k: int) -> None:
    out = run.prog.frame(k * run.spp, run.spp)
    run.values.append(out.reshape(-1, 3).index_select(0, run.pixels))


def warm(run) -> None:
    _frame(run, 0)
    sync(run.device)


def window(run, seconds: float) -> None:
    cfg = run.prog.cfg
    k = len(run.values)
    t0 = time.perf_counter()
    while True:
        _frame(run, k)
        sync(run.device)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.attempted = k - 1
    run.e2e["render_msamples_s"] = (
        run.attempted * cfg.width * cfg.height * run.spp
        / run.window_s / 1e6)


def check(run, control: bool = False) -> None:
    """Hold every frame's checked pixels, one frame each, to the
    reference; `control` puts the reference at bfloat16 in the program's
    place."""
    cfg = run.prog.cfg
    n, n_frames = run.pixels.numel(), len(run.values)
    got_all = torch.stack(run.values)                # (F, N, 3)
    run.values = None
    rng = np.random.default_rng([run.seed % (1 << 63), 2])
    frame_of = torch.as_tensor(rng.permutation(n) % n_frames,
                               dtype=torch.int64, device=run.device)
    got = got_all[frame_of, torch.arange(n, device=run.device)]
    del got_all
    ref = run.prog.reference(run)
    run.prog = None
    px = (run.pixels % cfg.width).to(torch.int32)
    py = (run.pixels // cfg.width).to(torch.int32)
    sample0 = frame_of * run.spp
    work = {}
    with torch.no_grad():
        cam = corners(ref.cfg, run.device)
        want = ref.launch_pixels(cam, px, py, sample0, run.spp, work)
        if control:
            with bf16_control():
                got = ref.launch_pixels(cam, px, py, sample0, run.spp)
    off = off_mask(got, want)                        # (N, 3)
    per_frame = torch.zeros(n_frames, device=run.device).index_add_(
        0, frame_of, off.float().sum(1))
    count = torch.bincount(frame_of, minlength=n_frames).clamp(min=1) * 3
    share = per_frame / count
    run.readings = {"off_share": float(off.float().mean()),
                    "worst_frame_off_share": float(share.max())}
    limit = load_limits(run.workload, run.spec.root)["worst_frame_off_share"]
    run.failed = int((share > limit).sum())
    # the work of the checked pixels' launches, scaled to one frame
    scale = cfg.width * cfg.height / n
    run.work = {"march": float(work.get("march", 0)) * scale,
                "shade": float(work.get("shade", 0)) * scale,
                "scaled_from_pixels": n, "frames": n_frames}
    run.ref_scene = ref.scene
