"""Render and train over a (tile, spp) layout of devices, across
processes (`multihost`), and elastic renders over sample shards
(`recovery`)."""
from raymarchrenderer_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, render_sharded, train_step_sharded, ShardConfig, auto_shard,
    gather_image,
)
from raymarchrenderer_tpu_torch.parallel import multihost  # noqa: F401
from raymarchrenderer_tpu_torch.parallel.recovery import (  # noqa: F401
    ElasticResult, ShardFailure, render_elastic, oracle_shard_fn,
    fused_shard_fn,
)
