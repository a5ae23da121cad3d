"""h2d_copies_per_launch.preview: the `cudaMemcpy*` runtime calls that
start inside the program's `rmr.scene_buffers` spans (the host-to-device
uploads of a launch's scene buffers), over the tile launches, the
program's `rmr_mega_paths` launch spans (`kernels.build.CudaKernel`)."""
from rmbench import spans


def read(run):
    launches = len(spans.spans(run.tr, "rmr_mega_paths"))
    if not launches or not spans.spans(run.tr, "rmr.scene_buffers"):
        return None
    return spans.calls_inside(run.tr, "rmr.scene_buffers",
                              "cudaMemcpy") / launches
