"""Scenes: `.scene` parsing, the object node library, builtin scenes."""

from raymarchrenderer_tpu_torch.scene.graph import (  # noqa: F401
    Light, MaterialDef, ObjectDef, Scene, load_scene, loads_scene,
    param_leaves, params_from_numpy, params_replace, params_to_numpy)
