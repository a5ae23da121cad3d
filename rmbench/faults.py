"""Faults planted under the timed path, each of which a cell's check has
to catch (`correct` false).  Each is a context manager that patches the
port for the block: the CPU tests plant them in a tiny run, and
`calibrate --fault` reads their numbers on the card at a cell's own
size.

  * `unchanged` — a step that returns its state unchanged: every frame
    draws the sequence's first samples again; the preview's merge leaves
    the accumulator as it was; the train step leaves the state as it
    was;
  * `half` — half of the batch left out, the mean taken over the rest:
    a frame launch of half its samples; a preview pass over half the
    tiles; a train step over half its samples;
  * `altered` — an answer altered where it is produced, raised by 1e-3:
    the second frame's values (the window's first frame); the values of
    the third tile launch of the second pass (the window's first).

The train faults leave the first `sound_calls` steps sound (set-up's
steps, the traffic's `first_steps`), so that they break the timed steps
alone.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _frames(kind, sound_calls):
    from raymarchrenderer_tpu_torch.kernels import march
    stack = contextlib.ExitStack()
    calls = []
    for name, i in (("render_fused_spectral", 5), ("render_fused", 4)):
        fn = getattr(march, name)

        def wrapped(*a, fn=fn, i=i, **k):
            if kind == "unchanged":
                a = a[:i] + (0,) + a[i + 1:]
            elif kind == "half":
                k["n_samples"] = max(k.get("n_samples", 1) // 2, 1)
            out = fn(*a, **k)
            calls.append(1)
            if kind == "altered" and len(calls) == 2:
                out = out + 1e-3
            return out
        stack.enter_context(_patched(march, name, wrapped))
    return stack


def _preview(kind, sound_calls):
    from raymarchrenderer_tpu_torch.render import tiles
    if kind == "unchanged":
        return _patched(tiles.ProgressiveRenderer, "_merge_fused",
                        lambda self, origin, tile, n, k: self.accum)
    if kind == "half":
        spiral = tiles.spiral_tiles
        return _patched(tiles, "spiral_tiles",
                        lambda w, h: list(spiral(w, h))[:w * h // 2])
    launch, calls = tiles.render_fused_patch_for_tiles, []

    def altered(*a, **k):
        out = launch(*a, **k)
        if int(a[6] if len(a) > 6 else k["sample0"]) != 1:
            return out
        calls.append(1)
        return out + 1e-3 if len(calls) == 3 else out
    return _patched(tiles, "render_fused_patch_for_tiles", altered)


def _train(kind, sound_calls):
    from raymarchrenderer_tpu_torch.parallel import sharding
    calls = []
    if kind == "unchanged":
        update = sharding.spectral_update

        def unchanged(params, mats, *a, **k):
            calls.append(1)
            if len(calls) <= sound_calls:
                return update(params, mats, *a, **k)
            return params, mats
        return _patched(sharding, "spectral_update", unchanged)
    if kind == "half":
        grads = sharding.train_grads_spectral_sharded

        def half(scene, params, mats, cfg, corners, target, spp, *a, **k):
            calls.append(1)
            if len(calls) > sound_calls:
                spp = max(spp // 2, 1)
            return grads(scene, params, mats, cfg, corners, target, spp,
                         *a, **k)
        return _patched(sharding, "train_grads_spectral_sharded", half)
    raise ValueError("a train step produces no answer to alter")


_DRIVERS = {"frames": _frames, "preview": _preview, "train": _train}
KINDS = {"frames": ("unchanged", "half", "altered"),
         "preview": ("unchanged", "half", "altered"),
         "train": ("unchanged", "half")}


def plant(driver: str, kind: str, sound_calls: int = 0):
    """The context manager that plants fault `kind` under `driver`'s
    timed path (`sound_calls`: the train steps left sound first)."""
    if kind not in KINDS[driver]:
        raise ValueError(f"no fault {kind!r} for the {driver} driver")
    return _DRIVERS[driver](kind, sound_calls)
