"""Tile scheduling: the reference's spiral chunk walk and its progressive
driver, over the RGB patch kernel.

`Program.cpp:107-299` splits the image into a gridW x gridH chunk grid and
walks it in a square spiral from the centre outward, rendering all samples
of a tile before advancing (samples > 0) or one sample per tile per pass
(samples == 0, endless).  `spiral_tiles` reproduces the visit order (its
off-centre start `ceil(g/2) - 1` and the distCount / squaresPassed turn
bookkeeping), from the native scheduler (`native/scheduler.cpp`) where its
library loads, else from `spiral_tiles_py`, which emits the same order.

`ProgressiveRenderer` drives the walk: with `impl="fused"` each tile's
samples are one launch of the RGB kernel (`kernels.march.render_fused_patch`
at the tile's origin, `csrc/mega_paths.cu` on the card), and an endless
pass, whose tiles share one sample index and cover the frame, is one
launch of the whole frame; with `impl="oracle"` each sample of a tile is
`integrator.render_patch`, folded into the running mean.  The accumulator
is a valid partial image after every tile of a finite pass and after
every endless pass, so a render can stop, be saved or be checkpointed at
any moment (Escape / S, `Program.cpp:188-194,303-306`).  Each pass runs
in the profiler span `rmr.pass` (`utils.profiling.span`).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import (accumulate,
                                                          render_patch)
from raymarchrenderer_tpu_torch.utils.profiling import span


def spiral_tiles(grid_w: int, grid_h: int) -> Iterator[Tuple[int, int]]:
    """Yield (x, y) tile coordinates in the reference's spiral order
    (`Program.cpp:113-119,196-299`): the native scheduler's where its
    library loads (`io.native_bindings` prints why it does not), else
    `spiral_tiles_py`'s, the same order."""
    from raymarchrenderer_tpu_torch.render import scheduler_native
    if scheduler_native.available():
        yield from scheduler_native.spiral_order(grid_w, grid_h)
        return
    yield from spiral_tiles_py(grid_w, grid_h)


def spiral_tiles_py(grid_w: int, grid_h: int) -> Iterator[Tuple[int, int]]:
    """The pure-Python spiral walk (the `Program.cpp:203-222`
    bookkeeping)."""
    x = -(-grid_w // 2) - 1   # ceil(g/2) - 1
    y = -(-grid_h // 2) - 1
    dx, dy = -1, 0
    squares = 0
    last_squares = 0
    dist_count = 0
    remaining = grid_w * grid_h
    # The reference stops after gridW * gridH steps, which skips tiles on
    # non-square grids (out-of-grid spiral steps consume the budget,
    # `Program.cpp:206-216,239`).  This walk goes on until every in-grid
    # tile was emitted: the same order on square grids, every tile on
    # rectangular ones, as the JAX package's.
    while remaining > 0:
        if 0 <= x < grid_w and 0 <= y < grid_h:
            yield (x, y)
            remaining -= 1
        x -= grid_w // 2
        y -= grid_h // 2
        if dist_count * 2 == squares - last_squares:
            dist_count += 1
            last_squares = squares
            dx, dy = dy, -dx
        elif dist_count == squares - last_squares:
            dx, dy = dy, -dx
        squares += 1
        x += dx
        y += dy
        x += grid_w // 2
        y += grid_h // 2


def _tile_sample(scene, params, cfg: RenderConfig, tile_shape, corners,
                 origin_xy, accum, n: float, sample: int,
                 direct_light: bool = False):
    """One sample of one tile (`integrator.render_patch`) folded into the
    accumulator's slice by the oracle's running mean at per-tile count
    `n`; returns the accumulator (updated in place)."""
    th, tw = tile_shape
    ox, oy = origin_xy
    with torch.no_grad():
        color = render_patch(scene, params, cfg, corners, (ox, oy),
                             tile_shape, sample, direct_light)
    tile = accum[oy:oy + th, ox:ox + tw]
    accum[oy:oy + th, ox:ox + tw] = accumulate(tile, color, n)
    return accum


class ProgressiveRenderer:
    """The progressive driver with the reference's two modes
    (`Program.cpp:182-299`): finite samples (all of a tile's samples, then
    the spiral moves on; `render_pass`) and endless (one sample per tile
    per pass; `endless_passes`).

    `impl`: "fused" renders each tile's samples of a finite pass, and each
    endless pass's whole frame, in one launch of the RGB patch kernel and
    merges it as (old * n + tile * k) / (n + k); "oracle"
    renders sample by sample in plain PyTorch; "auto" is "fused" on a
    CUDA card and "oracle" on the CPU (the JAX package's, with the card in
    the TPU's place).  The kernel's RNG is keyed on absolute pixels and
    sample indices, so a tile's launch computes the same pixels as a
    full-frame launch; the merge multiplies and divides by k, which is
    exact when k is a power of two: the tiled image is then byte-equal to
    one full-frame `render_fused` launch of `spp` samples (the JAX
    package's test uses 2).  A grid that does not divide the frame raises
    `ValueError`, the reference's integer-division limit."""

    def __init__(self, scene, params, cfg: RenderConfig, corners,
                 impl: str = "auto", direct_light: bool = False):
        self.scene = scene
        self.params = params
        self.cfg = cfg
        self.corners = corners
        self.direct_light = direct_light
        if impl == "auto":
            impl = "fused" if corners.device.type == "cuda" else "oracle"
        if impl not in ("fused", "oracle"):
            raise ValueError(f"impl must be 'auto', 'fused' or 'oracle', "
                             f"not {impl!r}")
        self.impl = impl
        if cfg.width % cfg.grid_width or cfg.height % cfg.grid_height:
            raise ValueError("image size must be divisible by the tile grid "
                             "(reference integer-division behavior)")
        self.tile_shape = (cfg.height // cfg.grid_height,
                           cfg.width // cfg.grid_width)
        self.accum = torch.zeros((cfg.height, cfg.width, 3),
                                 dtype=torch.float32, device=corners.device)
        self.pass_n = 0.0

    def _tile_origin(self, tx: int, ty: int) -> Tuple[int, int]:
        th, tw = self.tile_shape
        return (tx * tw, ty * th)

    def _merge_fused(self, origin, tile, n: float, k: float):
        """The running mean over launches on the slice that `tile` covers
        at `origin`: new = (old * n + tile * k) / (n + k)."""
        th, tw = tile.shape[:2]
        ox, oy = origin
        old = self.accum[oy:oy + th, ox:ox + tw]
        self.accum[oy:oy + th, ox:ox + tw] = (old * n + tile * k) / (n + k)
        return self.accum

    def _fused_patch(self, origin, shape, sample0: int, n_samples: int):
        return render_fused_patch_for_tiles(
            self.scene, self.params, self.cfg, self.corners, origin, shape,
            sample0, n_samples, self.direct_light)

    def render_pass(self, spp: int = None, callback=None):
        """Finite mode: every tile gets `spp` samples (default `cfg.spp`),
        in spiral order; `callback(tx, ty, accum)` after each tile.
        Returns the accumulator."""
        cfg = self.cfg
        spp = cfg.spp if spp is None else spp
        with span("rmr.pass"):
            for tx, ty in spiral_tiles(cfg.grid_width, cfg.grid_height):
                origin = self._tile_origin(tx, ty)
                if self.impl == "fused":
                    tile = self._fused_patch(origin, self.tile_shape, 0,
                                             spp)
                    self._merge_fused(origin, tile, 0.0, float(spp))
                else:
                    for s in range(spp):
                        _tile_sample(self.scene, self.params, cfg,
                                     self.tile_shape, self.corners, origin,
                                     self.accum, float(s), s,
                                     self.direct_light)
                if callback is not None:
                    callback(tx, ty, self.accum)
        self.pass_n = float(spp)
        return self.accum

    def endless_passes(self, n_passes: int, callback=None):
        """samples == 0 mode: one sample per tile per pass, `n_passes`
        passes; `callback(p, accum)` after each pass.

        With `impl="fused"` a pass is one launch of the whole frame at
        sample `pass_n`, merged once: the tiles of a pass share that
        sample index and cover the frame (the grid divides it), and the
        kernel's RNG is keyed on absolute pixels and sample indices, so
        the frame's launch computes each tile's pixels byte for byte, and
        the merge is elementwise.  Nothing between the tiles of a pass is
        reported.  The oracle walks the spiral tile by tile."""
        cfg = self.cfg
        for p in range(n_passes):
            with span("rmr.pass"):
                if self.impl == "fused":
                    frame = self._fused_patch((0, 0), (cfg.height, cfg.width),
                                              int(self.pass_n), 1)
                    self._merge_fused((0, 0), frame, self.pass_n, 1.0)
                else:
                    for tx, ty in spiral_tiles(cfg.grid_width,
                                               cfg.grid_height):
                        _tile_sample(self.scene, self.params, cfg,
                                     self.tile_shape, self.corners,
                                     self._tile_origin(tx, ty), self.accum,
                                     self.pass_n, int(self.pass_n),
                                     self.direct_light)
            self.pass_n += 1.0
            if callback is not None:
                callback(p, self.accum)
        return self.accum


def render_fused_patch_for_tiles(scene, params, cfg, corners, origin,
                                 tile_shape, sample0, n_samples,
                                 direct_light):
    """All `n_samples` of one tile, or of an endless pass's frame, in one
    launch of the RGB patch kernel (`render_fused_patch` at `origin`, the
    patch's (x, y)): the same pixels as those of a full-frame launch,
    since every per-lane value is keyed on absolute pixel coordinates and
    sample indices."""
    from raymarchrenderer_tpu_torch.kernels.march import render_fused_patch
    return render_fused_patch(scene, params, cfg, corners, origin,
                              tile_shape, sample0, n_samples=n_samples,
                              direct_light=direct_light)
