"""queued_launch_share.mega_paths: of the program's `rmr_mega_paths`
launch spans (`kernels.build.CudaKernel`) in the preview's window, the
share that start inside its `rmr.pixel_queue` spans
(`kernels.march._launch_mega_paths`, opened around a launch on the
persistent grid of the pixel queue): 1.0 where every launch takes the
queue, 0.0 where none does, as on a program without the span."""
from rmbench import spans


def read(run):
    launches = spans.spans(run.tr, "rmr_mega_paths")
    if not launches:
        return None
    queued = spans.Cover(spans.spans(run.tr, "rmr.pixel_queue"))
    return sum(1 for start, _ in launches if start in queued) / len(launches)
