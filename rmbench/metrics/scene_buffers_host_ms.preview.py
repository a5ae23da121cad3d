"""scene_buffers_host_ms.preview: host milliseconds per preview pass
inside the program's `rmr.scene_buffers` spans (`kernels.scene_program`
`paths_buffers`: each tile launch's scene program and data built and
uploaded), less the time inside them in runtime calls that wait for the
card or copy to it (the rule of `pass_host_ms.preview`); the spans'
time summed over the window, over its `rmr.pass` spans."""
from rmbench import spans


def read(run):
    n = len(spans.spans(run.tr, "rmr.pass"))
    if not n or not spans.spans(run.tr, "rmr.scene_buffers"):
        return None
    host, _ = spans.host_and_waits(run.tr, "rmr.scene_buffers")
    return host * 1e-3 / n
