"""Work counters, metrics logging, profiling, numeric guards and the
golden-parity gates."""

from raymarchrenderer_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger, RenderStats, instrumented_sample, mega_occupancy_profile,
    spectral_path_profile)
from raymarchrenderer_tpu_torch.utils.profiling import (  # noqa: F401
    compile_and_steady, timed_block, trace_to)
from raymarchrenderer_tpu_torch.utils.guards import (  # noqa: F401
    checked_render_sample)
