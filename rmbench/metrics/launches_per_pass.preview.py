"""launches_per_pass.preview: the program's `rmr_mega_paths` launch spans
(`kernels.build.CudaKernel`) that start inside its `rmr.pass` spans
(`render.tiles.ProgressiveRenderer`), over those passes: the launches
the tile driver cuts one preview pass into."""
from rmbench import spans


def read(run):
    passes = spans.spans(run.tr, "rmr.pass")
    launches = spans.spans(run.tr, "rmr_mega_paths")
    if not passes or not launches:
        return None
    inside = spans.Cover(passes)
    return sum(1 for start, _ in launches if start in inside) / len(passes)
