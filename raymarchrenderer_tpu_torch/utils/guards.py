"""Numeric guards: NaN detection stage by stage in the plain render.

The GLSL reference has no sanitizers (SURVEY.md §5): bad math silently
paints pixels black.  The JAX package instruments its `render_sample` with
`checkify.float_checks`; the port runs the same plain sample
(`render.integrator.render_sample`) with a `torch.isnan` check
after each stage of every bounce: the march's t, the normal, the shaded
colour, and at the end the accumulated image.  NaN only, as
`float_checks`: an inf is a value, not an error, here as in the JAX guard
(a scene may author an emitter's power or a sky as large as it likes).  On
the repo's scenes no stage carries one (a miss stops at `max_dist`, and so
does an empty scene's map), so the check costs no clean render.  Built on
demand: nothing runs unless called.
"""
from __future__ import annotations

import torch

from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.render.integrator import render_sample
from raymarchrenderer_tpu_torch.scene.graph import Scene


def _first_nan(stage: str, value) -> str:
    """`stage`'s message when `value` (a tensor or a Vec3) holds a NaN,
    else None."""
    parts = value if isinstance(value, tuple) else (value,)
    for part in parts:
        if torch.is_tensor(part) and bool(torch.isnan(part).any()):
            return f"NaN in {stage}"
    return None


def checked_render_sample(scene: Scene, params, cfg: RenderConfig, corners,
                          sample, direct_light: bool = False,
                          throw: bool = True):
    """One full-frame sample of the plain RGB render with NaN checks.

    Returns (err, image (H, W, 3)): `err` names the first stage that made
    a NaN ("NaN in normal at bounce 0", ...), or is None.  With `throw=True`
    (the default) a NaN raises FloatingPointError instead."""
    errors = []

    def check(stage, bounce, value):
        if not errors:
            err = _first_nan(f"{stage} at bounce {bounce}", value)
            if err:
                errors.append(err)

    with torch.no_grad():
        image = render_sample(scene, params, cfg, corners, sample,
                              direct_light, check=check).stack(-1)
    if not errors:
        err = _first_nan("accumulate", image)
        if err:
            errors.append(err)
    err = errors[0] if errors else None
    if err and throw:
        raise FloatingPointError(err)
    return err, image
