"""forward_device_ms.train: device milliseconds per train step of the
kernels, copies and fills launched inside the program's `rmr.forward`
span (`parallel.sharding`: the replay's differentiable forward and the
loss) and outside its `rmr.record` span (the recorder), matched to their
launching runtime call by correlation id."""
from rmbench import spans


def read(run):
    if not run.attempted or not spans.spans(run.tr, "rmr.forward"):
        return None
    events = spans.device_events_of(run.tr, "rmr.forward", "rmr.record")
    return sum(float(e["dur"]) for e in events) * 1e-3 / run.attempted
