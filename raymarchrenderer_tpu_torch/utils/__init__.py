"""Work counters, metrics logging and the golden-parity gates."""

from raymarchrenderer_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger, RenderStats, instrumented_sample, mega_occupancy_profile,
    spectral_path_profile)
