"""Image writers, the train target's readers and the .hdr codec."""

from raymarchrenderer_tpu_torch.io.hdr import (  # noqa: F401
    load_env_map, load_hdr, loads_hdr, save_hdr)
