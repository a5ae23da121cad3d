"""backward_device_ms.train: device milliseconds per train step of the
kernels, copies and fills launched inside the program's `rmr.backward`
span (`parallel.sharding`: the gradients by autograd, whose CUDA ops run
on autograd's own thread while the caller sits in the span), matched to
their launching runtime call by correlation id."""
from rmbench import spans


def read(run):
    if not run.attempted or not spans.spans(run.tr, "rmr.backward"):
        return None
    events = spans.device_events_of(run.tr, "rmr.backward")
    return sum(float(e["dur"]) for e in events) * 1e-3 / run.attempted
