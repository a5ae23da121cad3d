"""The yardstick's arithmetic: the H100's published peaks, the FP32 cost
of one scene-map evaluation, and the least time a render launch could
take.

Copied from the port's `chip_smoke.py` (`PEAK_FP32`, `PEAK_BYTES`,
`MARCH_STEP_FLOPS`, `_bound`) and `kernels/scene_program.py`
(`NODE_FLOPS`, `map_flops`), frozen here so that a change to the program
cannot move the bound it is judged against.  The work these inputs need
is counted by the benchmark's own plain reference (`rmbench.reference`:
the "march" and "shade" counts of the megakernel schedules), on a sample
of pixels, and scaled to the frame.
"""
from __future__ import annotations

# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
PEAK_FP32 = 67e12             # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3 bytes/s
MARCH_STEP_FLOPS = 8          # p = o + d*t, t += step

# FP32 operations of each object node as the kernels' interpreter
# evaluates it (an add, multiply, divide, min, max, abs, fmod, sqrt, sin
# or cos counts one)
NODE_FLOPS = {
    "map_sphere": 11, "map_box": 23, "map_plane": 17, "map_torus": 13,
    "map_cylinder": 19, "map_capsule": 34, "op_union": 3, "op_subtract": 3,
    "op_intersect": 3, "op_smooth_union": 13, "domain_repeat": 12,
    "misc_getX": 0, "misc_getY": 0, "misc_getZ": 0, "math_add": 3,
    "math_subtract": 3, "math_multiply": 3, "math_divide": 3,
    "math_sine": 3, "math_cosine": 3,
}


def map_flops(scene) -> int:
    """FP32 operations of one `map_dist` evaluation: every object's nodes
    and the running minimum over the objects (`scene` is the reference's
    parsed `Scene`)."""
    return (sum(NODE_FLOPS[n.name] for o in scene.objects for n in o.nodes)
            + max(len(scene.objects) - 1, 0))


def operations(scene, normal_taps: int, march: float, shade: float,
               lookups: int = 1) -> float:
    """FP32 operations of `march` map evaluations of live lanes and
    `shade` shaded hits, each with `lookups` material lookups and
    `normal_taps` taps (2 for the exact normal's reverse sweep); integer
    RNG hashing and material arithmetic are left out, so the bound is
    low."""
    mf = map_flops(scene)
    taps = normal_taps or 2
    return (march * (mf + MARCH_STEP_FLOPS)
            + shade * ((lookups + taps) * mf + 6 * taps + 11))


def bound_s(ops: float, n_bytes: float):
    """(seconds, "operations" or "bytes"): the least time the card could
    take, the larger of the FP32 operations over the FP32 peak and the
    bytes (each input read once, each output written once) over the HBM
    rate."""
    t_ops, t_bytes = ops / PEAK_FP32, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def launch_roofline_pct(run, kernel_part: str):
    """Percent of its roofline of the render megakernel whose device name
    holds `kernel_part`, in a frames run: the least time of one
    full-frame launch (the operations of the reference's count, scaled
    from the checked pixels to the frame, and the frame's bytes written
    once with the camera's read once; the scene's few hundred program
    words and data floats are left out) over the kernel's mean device
    time per launch.  None where the trace holds no such kernel or the
    run counted no work."""
    events = run.tr.kernels(kernel_part)
    if not events or not run.work.get("march"):
        return None
    mean_s = sum(float(e["dur"]) for e in events) * 1e-6 / len(events)
    cfg = run.config["render"]
    ops = operations(run.ref_scene, cfg["normal_taps"], run.work["march"],
                     run.work["shade"])
    n_bytes = cfg["width"] * cfg["height"] * 12 + 60
    return 100.0 * bound_s(ops, n_bytes)[0] / mean_s

