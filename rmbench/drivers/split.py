"""Closed loop of frames split over a (tile, spp) layout of cards: frame k
is one `parallel.sharding.render_sharded_spectral` call of `spp` samples
from sample k * spp (the progressive sequence continued) over
`make_mesh(ShardConfig(tile, spp))` of the configuration's `layout`, one
megakernel launch a position, each position on a card of its own, merged
on cuda:0; the next frame starts when the merged frame is ready.  Frame 0
is the warm-up.

Traffic parameters: `check_pixels`, the pixels the check compares.

After each frame the values of the check's pixels are gathered from the
merged frame; once the window has closed every checked pixel is given one
frame, all frames as evenly as the count allows, both drawn from the seed,
and the reference (`reference.split.merged_pixels`: each sample slice one
launch, summed in si order, one divide) works out that pixel of that
frame again.  Numbers: `off_share`, the share of the values off;
`worst_frame_off_share`, the largest share of one frame's values off;
`worst_position_off_share`, the largest share of the values off among
the checked pixels of one position, so that one card's fault shows whole
(a pixel holds the slices of every position of its tile, so the positions
of one tile share their pixels).

`render_msamples_s`: the pixel-samples of every frame completed in the
window over the window's wall time; the window ends at the first frame
boundary after `--seconds`.

On the CPU (the tests' `device`) the positions are virtual: the one
device repeated, each position rendered after the other.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from rmbench import harness
from rmbench.check import bf16_control, load_limits, off_mask
from rmbench.program import Program, sync
from rmbench.reference.render import corners
from rmbench.reference.split import merged_pixels


def _devices(run, n: int) -> list:
    if run.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [run.device] * n


def setup(run) -> None:
    from raymarchrenderer_tpu_torch.parallel.sharding import (ShardConfig,
                                                              make_mesh)
    prog = Program(run)
    layout = ShardConfig(int(run.config["layout"]["tile"]),
                         int(run.config["layout"]["spp"]))
    run.mesh = make_mesh(layout, _devices(run, layout.total()))
    run.devices = sorted({d for row in run.mesh.devices for d in row},
                         key=str)
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
    from raymarchrenderer_tpu_torch.parallel.sharding import (
        render_sharded_spectral)
    p = run.prog
    out = render_sharded_spectral(p.scene, p.params, p.mats, p.cfg,
                                  p.corners, run.spp, mesh=run.mesh,
                                  sample0=k * run.spp)
    run.values.append(out.reshape(-1, 3).index_select(0, run.pixels))


def _sync(run) -> None:
    for dev in run.devices:
        sync(dev)


def warm(run) -> None:
    _frame(run, 0)
    _sync(run)


def window(run, seconds: float) -> None:
    cfg = run.prog.cfg
    k = len(run.values)
    t0 = time.perf_counter()
    while True:
        _frame(run, k)
        _sync(run)
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
    reference's merged frame; `control` puts the reference at bfloat16 in
    the program's place."""
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
    n_tile, n_spp = run.mesh.shape["tile"], run.mesh.shape["spp"]
    px = (run.pixels % cfg.width).to(torch.int32)
    py = (run.pixels // cfg.width).to(torch.int32)
    sample0 = frame_of * run.spp
    work = {}
    with torch.no_grad():
        cam = corners(ref.cfg, run.device)
        want = merged_pixels(ref, cam, px, py, sample0, run.spp, n_spp, work)
        if control:
            with bf16_control():
                got = merged_pixels(ref, cam, px, py, sample0, run.spp,
                                    n_spp)
    off = off_mask(got, want).float()                # (N, 3)

    def worst(group, n_groups):
        per = torch.zeros(n_groups, device=run.device).index_add_(
            0, group, off.sum(1))
        count = torch.bincount(group, minlength=n_groups).clamp(min=1) * 3
        return per / count

    share = worst(frame_of, n_frames)
    rows_per = -(-cfg.height // n_tile)
    tile_share = worst((py // rows_per).to(torch.int64), n_tile)
    run.readings = {"off_share": float(off.mean()),
                    "worst_frame_off_share": float(share.max()),
                    "worst_position_off_share": float(tile_share.max())}
    limit = load_limits(run.workload, run.spec.root)["worst_frame_off_share"]
    run.failed = int((share > limit).sum())
    # the work of the checked pixels' launches, scaled to one frame
    scale = cfg.width * cfg.height / n
    run.work = {"march": float(work.get("march", 0)) * scale,
                "shade": float(work.get("shade", 0)) * scale,
                "scaled_from_pixels": n, "frames": n_frames}
    run.ref_scene = ref.scene
