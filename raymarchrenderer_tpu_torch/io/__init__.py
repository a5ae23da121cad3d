"""Image writers, the train target's readers, the .hdr codec and the
render checkpoints."""

from raymarchrenderer_tpu_torch.io.checkpoint import (  # noqa: F401
    RenderState, SceneMismatchError, load_checkpoint, save_checkpoint)
from raymarchrenderer_tpu_torch.io.hdr import (  # noqa: F401
    load_env_map, load_hdr, loads_hdr, save_hdr)
