"""Vector math, RNG, SDFs, sampling, spectral colour, colour transfer and
the camera."""

from raymarchrenderer_tpu_torch.core.vecmath import (  # noqa: F401
    Vec3, make_onb, reflect, refract, rotate_axis, vlerp, vselect,
)
from raymarchrenderer_tpu_torch.core import (  # noqa: F401
    camera, color, rng, sampling, sdf, spectral,
)
