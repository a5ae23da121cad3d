"""tpu-raymarch, PyTorch + CUDA port.

The second package beside the JAX/Pallas reference `raymarchrenderer_tpu`:
the same subpackages and module names, plain PyTorch around hand-written
CUDA kernels for the NVIDIA H100 (`csrc/`).  It imports torch and numpy
only, never jax and never the reference package.

  * `core`    — vector math, counter-based RNG, SDFs, sampling, camera,
                spherical harmonics (the SH sky)
  * `scene`   — `.scene` parsing, the object and material node
                libraries, `Scene.shade`, builtin scenes
  * `render`  — config, ray generation, normals, the march, the wavefront
                RGB integrator (`trace_rgb`), the spectral band table and
                the eager megakernel schedules (the kernels' plain
                versions)
  * `diff`    — the implicit-function march adjoint under torch autograd
  * `kernels` — the CUDA kernels' (RGB and spectral megakernels with the
                deferred env sky, their wavefront modes, the recorders,
                `march_fused`) scene compiler, build, bind and wrappers
  * `parallel`— the render and the train step over the device layout
  * `io`      — BMP/PNG/NPY writers, the train target's readers, the
                Radiance .hdr codec of the env maps
  * `app`     — the CLI: `render` (RGB with `--env-map`, and
                `--spectral`) and `train`
"""

from raymarchrenderer_tpu_torch.core.camera import Camera  # noqa: F401
from raymarchrenderer_tpu_torch.render.config import RenderConfig  # noqa: F401
