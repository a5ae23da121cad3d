"""Render metrics: the work counters behind the rates, and a JSONL log.

The port of the JAX package's `utils/metrics.py`.  The reference's only
runtime telemetry is `std::cout`: the per-sample counter
(`Program.cpp:201`) and the wall render time (`Program.cpp:192,245,296`).
Here:

  * `spectral_path_profile` — per-sample means of the spectral
    transport's work (segments marched, march map evaluations, hits
    shaded, and the derived map evaluations) from
    `trace_spectral(profile=True)`: the numbers `bench.py` prints beside
    Mpix·spp/s;
  * `mega_occupancy_profile` — the march occupancy of the spectral
    megakernel schedule from `trace_mega_spectral(with_occupancy=True)`;
  * `instrumented_sample` — one full-frame sample plus the primary
    segment's march profile (`march(with_steps=True)`), aggregated into a
    `RenderStats` (hit rate, mean steps, a steps histogram);
  * `MetricsLogger` — structured JSONL lines with wall-clock stamps.

Each runs the plain PyTorch versions eagerly, on the device of the
`corners` tensor: the counts are those of the strict oracle and the
counter-based RNG, so a card and the CPU give the same numbers up to the
rare lane whose march a float ulp moves.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from raymarchrenderer_tpu_torch.core.rng import RNGStream
from raymarchrenderer_tpu_torch.core.vecmath import Vec3
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import march, render_sample
from raymarchrenderer_tpu_torch.render.raygen import (eye_vec, pixel_grid,
                                                      primary_rays)
from raymarchrenderer_tpu_torch.scene.graph import Scene


@dataclasses.dataclass
class RenderStats:
    """Aggregated per-sample work profile."""
    pixels: int
    primary_hit_rate: float
    mean_primary_steps: float
    steps_histogram: np.ndarray      # counts per step bucket
    steps_bucket_edges: np.ndarray
    wall_s: float = 0.0

    @property
    def rays_per_s(self) -> float:
        return self.pixels / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "pixels": self.pixels,
            "primary_hit_rate": round(self.primary_hit_rate, 4),
            "mean_primary_steps": round(self.mean_primary_steps, 2),
            "steps_histogram": self.steps_histogram.tolist(),
            "steps_bucket_edges": self.steps_bucket_edges.tolist(),
            "wall_s": round(self.wall_s, 4),
            "rays_per_s": round(self.rays_per_s, 1),
        }


def _eye_planes(corners, shape) -> Vec3:
    e = eye_vec(corners)
    return Vec3(e.x.expand(shape), e.y.expand(shape), e.z.expand(shape))


def _primary_rays(cfg: RenderConfig, corners, px, py, sample) -> Vec3:
    rng = RNGStream(cfg.seed, px, py, int(sample), 1 << 20)
    return primary_rays(corners, px, py, cfg.width, cfg.height, rng)


def _primary_profile(scene: Scene, params, cfg: RenderConfig, corners,
                     sample):
    """(hit int32, steps int32) of every pixel's primary segment, marched
    by the production `march` with its step counter."""
    shape = (cfg.height, cfg.width)
    px, py = pixel_grid(cfg.width, cfg.height, corners.device)
    d = _primary_rays(cfg, corners, px, py, sample)
    ones = torch.ones(shape, dtype=torch.float32, device=corners.device)
    active = torch.ones(shape, dtype=torch.bool, device=corners.device)
    with torch.no_grad():
        _, _, hit_b, steps = march(scene, params, cfg,
                                   _eye_planes(corners, shape), d, ones,
                                   active, with_steps=True)
    return hit_b.to(torch.int32), steps


def _per_lane_mean(counts, n: int) -> float:
    # JAX's jnp.sum(int32) / n: the int32 sum as float32 over float32(n)
    return float(np.float32(int(counts.sum())) / np.float32(n))


def spectral_path_profile(scene: Scene, params, mats, cfg: RenderConfig,
                          corners, sample, n_samples: int = 4) -> dict:
    """The spectral transport's measured work per sample: runs
    `trace_spectral(profile=True)` over the full frame for the samples
    `sample`, ..., `sample + n_samples - 1` and returns per-sample means of
    the path segments marched, the march-loop map evaluations and the
    shaded hits, and the derived map evaluations (march + `normal_taps`
    per shaded hit; 2 for the exact normal)."""
    from raymarchrenderer_tpu_torch.render.spectral_integrator import (
        trace_spectral)

    shape = (cfg.height, cfg.width)
    n = cfg.width * cfg.height
    px, py = pixel_grid(cfg.width, cfg.height, corners.device)
    eye = _eye_planes(corners, shape)
    acc = np.zeros(3)
    with torch.no_grad():
        for k in range(n_samples):
            s = int(sample) + k
            d = _primary_rays(cfg, corners, px, py, s)
            _, _, segs, msteps, hits = trace_spectral(
                scene, params, mats, cfg, eye, d, px, py, s, profile=True)
            acc += [_per_lane_mean(c, n) for c in (segs, msteps, hits)]
    segs, msteps, hits = acc / n_samples
    taps = cfg.normal_taps if cfg.normal_taps > 0 else 2
    map_evals = msteps + hits * taps
    return {
        "segments_per_sample": round(float(segs), 4),
        "march_map_evals_per_sample": round(float(msteps), 4),
        "hits_per_sample": round(float(hits), 4),
        "map_evals_per_sample": round(float(map_evals), 4),
        "profile_samples": n_samples,
    }


def steps_histogram(steps, edges: np.ndarray) -> np.ndarray:
    """`jnp.histogram(steps, bins=edges)` as an exact bincount over the
    same float32 edges: bin i holds edges[i] <= x < edges[i + 1], the last
    bin also x == edges[-1]; values outside the edges are not counted."""
    e = torch.as_tensor(np.asarray(edges, np.float32), device=steps.device)
    x = steps.to(torch.float32).reshape(-1)
    idx = torch.searchsorted(e, x, right=True)
    idx = torch.where(x == e[-1], len(e) - 1, idx)
    counts = torch.bincount(idx, minlength=len(e) + 1)
    return counts[1:len(e)].cpu().numpy().astype(np.int32)


def instrumented_sample(scene: Scene, params, cfg: RenderConfig, corners,
                        sample, n_buckets: int = 16,
                        direct_light: bool = False):
    """One full-frame sample plus its work profile: returns (color
    (H, W, 3), RenderStats), the histogram over `n_buckets` equal buckets
    of [0, max_steps] (`steps_histogram`, the JAX package's edges)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        color = render_sample(scene, params, cfg, corners, sample,
                              direct_light=direct_light).stack(-1)
    hitm, steps = _primary_profile(scene, params, cfg, corners, sample)
    edges = np.linspace(0, cfg.max_steps, n_buckets + 1)
    hist = steps_histogram(steps, edges)
    hit_rate = float(hitm.to(torch.float32).mean())
    mean_steps = float(steps.to(torch.float32).mean())
    wall = time.perf_counter() - t0
    stats = RenderStats(
        pixels=cfg.width * cfg.height, primary_hit_rate=hit_rate,
        mean_primary_steps=mean_steps, steps_histogram=hist,
        steps_bucket_edges=edges, wall_s=wall)
    return color, stats


class MetricsLogger:
    """Structured JSONL metrics stream (stdout or file), the upgrade of the
    reference's `std::cout <<` progress prints."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "a") if path else None

    def log(self, event: str, **fields):
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        else:
            print(line, flush=True)

    def log_stats(self, event: str, stats: RenderStats, **fields):
        self.log(event, **stats.to_dict(), **fields)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def mega_occupancy_profile(scene, params, mats, cfg, corners, sample,
                           n_samples: int = 8, tiles: int = 8,
                           bh: int = 32, bw: int = 128,
                           march_unroll: int = None,
                           lazy_miss: bool = None,
                           regen_cadence: int = None) -> dict:
    """The masked-lane occupancy of the spectral megakernel schedule:
    march steps that marched over every lane's steps, from
    `trace_mega_spectral(with_occupancy=True)` on `tiles` (bh, bw) tiles
    spread over the frame, with the production schedule knobs by default.
    One call per tile, as the JAX package's per-tile loop: the batch sets
    when the loop exits, so batching the tiles would change the count."""
    from raymarchrenderer_tpu_torch.kernels.march import (
        DEFAULT_LAZY_MISS, DEFAULT_MARCH_UNROLL, DEFAULT_REGEN_CADENCE)
    from raymarchrenderer_tpu_torch.render.mega import trace_mega_spectral

    march_unroll = (DEFAULT_MARCH_UNROLL if march_unroll is None
                    else march_unroll)
    lazy_miss = DEFAULT_LAZY_MISS if lazy_miss is None else lazy_miss
    regen_cadence = (DEFAULT_REGEN_CADENCE if regen_cadence is None
                     else regen_cadence)
    th, tw = max(cfg.height // bh, 1), max(cfg.width // bw, 1)
    idxs = np.unique(np.linspace(0, th * tw - 1, tiles).astype(int))
    m_tot = 0.0
    t_tot = 0.0
    with torch.no_grad():
        for ti in idxs:
            i, j = divmod(int(ti), tw)
            px, py = pixel_grid(bw, bh, corners.device, (j * bw, i * bh))
            _, m, t = trace_mega_spectral(
                scene, params, mats, cfg, corners, px, py, sample,
                n_samples=n_samples, march_unroll=march_unroll,
                lazy_miss=lazy_miss, regen_cadence=regen_cadence,
                with_occupancy=True)
            m_tot += float(int(m.sum()))
            t_tot += float(int(t.sum()))
    return {
        "march_occupancy": round(m_tot / max(t_tot, 1.0), 4),
        "occupancy_tiles": int(len(idxs)),
        "occupancy_spp": n_samples,
    }
