"""launches_per_step.train: device kernels per train step in the traced
window (CUPTI kernel events; copies and fills not counted)."""


def read(run):
    n = sum(1 for e in run.tr.device if e.get("cat") == "kernel")
    if not n or not run.attempted:
        return None
    return n / run.attempted
