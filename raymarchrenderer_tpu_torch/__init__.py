"""tpu-raymarch, PyTorch + CUDA port.

The second package beside the JAX/Pallas reference `raymarchrenderer_tpu`:
the same subpackages and module names, plain PyTorch around hand-written
CUDA kernels for the NVIDIA H100 (`csrc/`).  It imports torch and numpy
only, never jax and never the reference package.

  * `core`    — vector math, counter-based RNG, SDFs, sampling, camera
  * `scene`   — `.scene` parsing, the object node library, builtin scenes
  * `render`  — config, ray generation, normals, the spectral band table
                and the eager megakernel schedule (the kernel's plain
                version)
  * `kernels` — the CUDA spectral megakernel's build, bind and wrapper
  * `io`      — BMP/PNG/NPY writers
  * `app`     — the `render --spectral` CLI
"""

from raymarchrenderer_tpu_torch.core.camera import Camera  # noqa: F401
from raymarchrenderer_tpu_torch.render.config import RenderConfig  # noqa: F401
