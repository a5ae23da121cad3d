"""roofline_pct.split4: percent of the frame's roofline on the cell's
cards in the split cell: the least time of one frame, the reference's
march and shade counts scaled from the checked pixels to the frame
(`roofline.operations`) and the frame written once, at the cards' summed
peaks (`roofline.bound_s` over the number of cards), over the mean device
span of a frame, from its first `mega_spectral_kernel` start on any card
to the end of its merge's last operation (`split_trace.frames`)."""
from rmbench import roofline, split_trace


def read(run):
    frames = split_trace.frames(run.tr)
    if not frames or not run.work.get("march"):
        return None
    span_us = [max(split_trace.end(e) for e in f["merge"] + sum(
                   f["kernels"].values(), []))
               - min(split_trace.start(e) for ks in f["kernels"].values()
                     for e in ks) for f in frames]
    mean_s = sum(span_us) * 1e-6 / len(span_us)
    cfg = run.config["render"]
    ops = roofline.operations(run.ref_scene, cfg["normal_taps"],
                              run.work["march"], run.work["shade"])
    n_bytes = cfg["width"] * cfg["height"] * 12 + 60
    least = roofline.bound_s(ops, n_bytes)[0] / int(run.cell["chips"])
    return 100.0 * least / mean_s
