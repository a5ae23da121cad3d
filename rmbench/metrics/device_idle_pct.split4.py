"""device_idle_pct.split4: the mean over the cell's cards of each card's
share of the traced window with no kernel, copy or fill on it, in
percent (the events split by their card: `Trace.busy_s` unions every
card's)."""
from rmbench import split_trace


def read(run):
    if run.tr is None or run.tr.window_s <= 0:
        return None
    cards = range(int(run.cell["chips"]))
    return 100.0 * sum(1.0 - split_trace.card_busy_share(run.tr, c)
                       for c in cards) / len(cards)
