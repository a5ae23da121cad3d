"""replay_device_ms.train: device milliseconds per step outside the
recorder (the replay's forward and backward, the loss and the update):
the window's busy time less the recorder kernel's, over its steps."""


def read(run):
    if not run.attempted or run.tr.busy_s <= 0:
        return None
    rec = sum(float(e["dur"]) for e in
              run.tr.kernels("record_spectral_kernel")) * 1e-6
    return (run.tr.busy_s - rec) * 1e3 / run.attempted
