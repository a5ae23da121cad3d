"""tile_launch_ms.preview: mean device milliseconds of one tile launch
of the RGB render megakernel (`mega_paths_kernel`, one sample of a 256^2
tile) in the preview's traced window."""


def read(run):
    events = run.tr.kernels("mega_paths_kernel")
    if not events:
        return None
    return sum(float(e["dur"]) for e in events) * 1e-3 / len(events)
