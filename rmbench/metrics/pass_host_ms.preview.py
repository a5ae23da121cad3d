"""pass_host_ms.preview: mean host milliseconds of one preview pass
inside the program's `rmr.pass` span (`render.tiles.ProgressiveRenderer`:
the spiral, each tile's launch path and merge), less the time inside it
in runtime calls that wait for the card or copy to it (any
`*Synchronize`, any `cudaMemcpy*`), the rule of
`driver_host_ms.preview`; averaged over the spans."""
from rmbench import spans


def read(run):
    n = len(spans.spans(run.tr, "rmr.pass"))
    if not n:
        return None
    host, _ = spans.host_and_waits(run.tr, "rmr.pass")
    return host * 1e-3 / n
