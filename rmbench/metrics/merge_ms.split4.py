"""merge_ms.split4: device milliseconds per frame of the copies, adds and
joins launched inside the program's `rmr.merge` span
(`parallel.sharding`: the parts copied to cuda:0, summed, joined and
divided), matched to their launching runtime call by correlation id
(`split_trace.frames`)."""
from rmbench import split_trace


def read(run):
    frames = split_trace.frames(run.tr)
    if not frames:
        return None
    return sum(float(e["dur"]) for f in frames
               for e in f["merge"]) * 1e-3 / len(frames)
