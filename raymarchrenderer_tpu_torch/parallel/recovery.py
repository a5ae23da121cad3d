"""Failure detection and elastic recovery for renders cut into sample
shards: the JAX package's `parallel/recovery.py` for the port.

Progressive rendering is a mean over samples, and adding samples is
associative and commutative, so a render can be cut into independent spp
shards.  Each shard returns the raw per-pixel sum of its samples, and the
merge divides once by the number of samples that arrived.  A shard lost
to a failed host or card is re-run (a retry budget) or dropped; a dropped
shard only lowers the effective spp, and the image stays an unbiased
estimate, as if fewer samples had been asked for.  (The reference has no
failure story; its nearest is Escape keeping the partial accumulation,
`Program.cpp:188-194`.)

The RNG is keyed on absolute sample indices (core/rng.py), so a retried
shard reproduces the same sums bit for bit wherever and whenever it runs.
The sums are merged on the host in float32.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import numpy as np
import torch


@dataclasses.dataclass
class ShardFailure:
    """Record of one failed shard execution."""
    sample0: int
    n_samples: int
    attempt: int
    error: str
    ts: float


@dataclasses.dataclass
class ElasticResult:
    image: np.ndarray            # (H, W, 3) mean over achieved samples
    spp_requested: int
    spp_achieved: int            # == requested unless shards were dropped
    failures: List[ShardFailure]
    dropped_shards: List[int]    # sample0 of shards lost for good

    @property
    def degraded(self) -> bool:
        return self.spp_achieved < self.spp_requested


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def render_elastic(run_shard: Callable, height: int, width: int, spp: int,
                   shard_spp: int = 8, max_retries: int = 1,
                   logger=None) -> ElasticResult:
    """Drive `run_shard(sample0, n_samples) -> (H, W, 3) raw sample sum`
    (a tensor on any device, or an array) over ceil(spp / shard_spp)
    shards with failure detection and retry.

    `run_shard` is the distribution boundary: locally it wraps a launch;
    across hosts, a collective or a call to a worker.  Any exception it
    raises is a shard failure: the shard is retried up to `max_retries`
    times and then dropped.  The merge divides by the samples that arrived,
    so the image is always an unbiased (noisier) estimate.  `logger.log(
    event, **fields)` sees each failure and drop."""
    total = np.zeros((height, width, 3), np.float32)
    achieved = 0
    failures: List[ShardFailure] = []
    dropped: List[int] = []

    for s0 in range(0, spp, shard_spp):
        k = min(shard_spp, spp - s0)
        got = None
        for attempt in range(max_retries + 1):
            try:
                got = _host(run_shard(s0, k))
                break
            except Exception as e:  # the failure detection boundary
                failures.append(ShardFailure(
                    sample0=s0, n_samples=k, attempt=attempt,
                    error=f"{type(e).__name__}: {e}", ts=time.time()))
                if logger is not None:
                    logger.log("shard_failure", sample0=s0, attempt=attempt,
                               error=str(e))
        if got is None:
            dropped.append(s0)
            if logger is not None:
                logger.log("shard_dropped", sample0=s0, n_samples=k)
            continue
        total += got
        achieved += k

    img = total / max(achieved, 1)
    return ElasticResult(image=img, spp_requested=spp, spp_achieved=achieved,
                         failures=failures, dropped_shards=dropped)


def oracle_shard_fn(scene, params, cfg, corners,
                    direct_light: bool = False) -> Callable:
    """A local `run_shard` over the oracle integrator: the raw per-pixel
    sum of samples [sample0, sample0 + n), `render_sample` per absolute
    sample index, on the corners' device."""
    from raymarchrenderer_tpu_torch.render.integrator import render_sample

    def run(sample0: int, n: int):
        acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                          device=corners.device)
        with torch.no_grad():
            for s in range(sample0, sample0 + n):
                acc = acc + render_sample(scene, params, cfg, corners, s,
                                          direct_light=direct_light).stack(-1)
        return acc

    return run


def fused_shard_fn(scene, params, cfg, corners) -> Callable:
    """A local `run_shard` over the RGB kernel: one `render_fused_patch`
    launch of the whole frame with `normalize=False` (the raw sums of
    `parallel.sharding.render_sharded`; the plain version on the CPU)."""
    from raymarchrenderer_tpu_torch.kernels.march import render_fused_patch

    def run(sample0: int, n: int):
        with torch.no_grad():
            return render_fused_patch(
                scene, params, cfg, corners, (0, 0), (cfg.height, cfg.width),
                sample0, n_samples=n, normalize=False)

    return run
