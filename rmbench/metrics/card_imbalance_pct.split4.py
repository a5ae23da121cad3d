"""card_imbalance_pct.split4: the mean over the frames of the split cell
of (the slowest card's `mega_spectral_kernel` time - the fastest card's)
/ the slowest card's, in percent (`split_trace.frames`): the tile axis's
load balance, what a frame waits for beyond its fastest card."""
from rmbench import split_trace


def read(run):
    frames = split_trace.frames(run.tr)
    if not frames:
        return None
    shares = []
    for f in frames:
        times = [sum(float(e["dur"]) for e in ks)
                 for ks in f["kernels"].values()]
        shares.append(100.0 * (max(times) - min(times)) / max(times))
    return sum(shares) / len(shares)
