"""record_ms.train: mean device milliseconds of one launch of the
spectral recorder (`rmr_record_spectral`, device kernel
`record_spectral_kernel`), one a step, in the traced window."""


def read(run):
    events = run.tr.kernels("record_spectral_kernel")
    if not events:
        return None
    return sum(float(e["dur"]) for e in events) * 1e-3 / len(events)
