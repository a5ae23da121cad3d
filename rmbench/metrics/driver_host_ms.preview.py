"""driver_host_ms.preview: mean host milliseconds of one pass inside
`ProgressiveRenderer.endless_passes(1)` (the spiral, each tile's launch
path and merge) that the host spends on its own work: each
`rmbench.driver_host` span of the traced window less the time inside it
in runtime calls that wait for the card or copy to it (any
`*Synchronize`, any `cudaMemcpy*`: a tile's pageable upload of its
scene buffers waits there for the tile before it), averaged over the
spans."""
from rmbench.trace import union

SPAN = "rmbench.driver_host"


def _waits(name: str) -> bool:
    return name.endswith("Synchronize") or name.startswith("cudaMemcpy")


def read(run):
    spans = [e for e in run.tr.host if e.get("cat") == "user_annotation"
             and e["name"] == SPAN]
    if not spans:
        return None
    waits = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in run.tr.host
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and _waits(e["name"])])
    own = 0.0
    for e in spans:
        a = float(e["ts"])
        b = a + float(e["dur"])
        own += (b - a) - sum(max(0.0, min(w1, b) - max(w0, a))
                             for w0, w1 in waits)
    return own * 1e-3 / len(spans)
