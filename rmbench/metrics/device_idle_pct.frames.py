"""device_idle_pct.frames: percent of the traced window in which no kernel,
copy or fill ran on the card."""


def read(run):
    if run.tr is None or run.tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.tr.busy_s / run.tr.window_s)
