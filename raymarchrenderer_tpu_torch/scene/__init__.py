"""Scenes: `.scene` parsing, the object node library, builtin scenes."""

from raymarchrenderer_tpu_torch.scene.graph import (  # noqa: F401
    Scene, load_scene, loads_scene, params_from_numpy)
