"""launch_skew_ms.split4: the mean over the frames of the split cell of
the last card's first `mega_spectral_kernel` start less the first card's,
in device milliseconds (`split_trace.frames`): near 0 when the cards
render at once, near one position's kernel time when they run one after
another."""
from rmbench import split_trace


def read(run):
    frames = split_trace.frames(run.tr)
    if not frames:
        return None
    skews = []
    for f in frames:
        firsts = [min(split_trace.start(e) for e in ks)
                  for ks in f["kernels"].values()]
        skews.append(max(firsts) - min(firsts))
    return sum(skews) * 1e-3 / len(skews)
