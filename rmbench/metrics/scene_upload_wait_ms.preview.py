"""scene_upload_wait_ms.preview: milliseconds per preview pass inside the
program's `rmr.scene_buffers` spans spent in runtime calls that wait for
the card or copy to it (any `*Synchronize`, any `cudaMemcpy*`): each tile
launch's pageable upload of its scene buffers, which waits there for the
tile before it; summed over the window, over its `rmr.pass` spans."""
from rmbench import spans


def read(run):
    n = len(spans.spans(run.tr, "rmr.pass"))
    if not n or not spans.spans(run.tr, "rmr.scene_buffers"):
        return None
    _, waiting = spans.host_and_waits(run.tr, "rmr.scene_buffers")
    return waiting * 1e-3 / n
