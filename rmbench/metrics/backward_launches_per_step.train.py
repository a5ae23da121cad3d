"""backward_launches_per_step.train: device kernels per train step
launched inside the program's `rmr.backward` span (CUPTI kernel events,
matched to their launching runtime call by correlation id, on any
thread; copies and fills not counted)."""
from rmbench import spans


def read(run):
    if not run.attempted or not spans.spans(run.tr, "rmr.backward"):
        return None
    events = spans.device_events_of(run.tr, "rmr.backward")
    return sum(1 for e in events if e.get("cat") == "kernel") / run.attempted
