"""The RGB recorder's later-bounce t: how far the kernel, its plain
version on the card and its plain version on the CPU drift apart.

The banks' bar (tests/_torch_parity.py): decisions exact, bounce 0's t
within 1e-5, and fewer than 5% of the later bounces' both-hit t entries
(`LATER_FRAC_OFF`) off by more than 1e-4.  A later bounce starts from a
hit point and a direction through sin, cos and sqrt, so two builds whose
functions differ by an ulp stop a grazing ray at another point of the
surface.  On sphere_on_floor's 37 x 53 patch at (11, 5) of a 96 x 64
frame (2 samples, 4 bounces, relax 1.9), on an NVIDIA H100 80GB HBM3:

    max_steps, seed        192, 0   192, 1   512, 0
    kernel vs card plain   0        0        0        (banks equal)
    kernel vs CPU plain    1.16%    0.65%    1.15%
    card vs CPU plain      1.16%    0.65%    1.15%

Once the card's plain version read 5.25%, 4.25% and 5.23% against the
kernel: torch's CUDA build divides a tensor by a Python number as a
product with its reciprocal, an ulp off the quotient the CPU and the
kernels compute, and raygen's division by the frame's width and height
moved every primary ray.  `--bisect` below found it: on the card, the
plain recorder with only `Tensor.div` run on the CPU read 1.16%, with
every float op but `div` on the CPU 5.16%.  The plain versions divide by
Python numbers through `core.vecmath.div` now.  The plain version on the
CPU against itself with sin and cos one ulp up reads 1.07% and 1.11% at
192 steps: the kernel and the card's plain version share CUDA's sin and
cos, an ulp from the CPU's.

    PYTHONPATH=. python tests/test_torch_record_drift.py [--bisect |
                                                          --bisect-exact]

prints, on the card, one JSON line per configuration: the kernel against
the plain version on the card and on the CPU, the two plain versions
against each other, and the SHA-256 of the kernel's banks (run it from
another checkout's root, with PYTHONPATH=., to read that tree's kernel);
with `--bisect`, the card's plain run with torch's float ops moved to
the CPU one by one (`bisect`).  Without a card it prints the plain
version against itself with sin and cos one ulp up.

`--bisect-exact` reads the exact-normal NEE case of recorder #5
(`record_exact`): the kernel against two plain runs on the card, then
against the plain run with each float aten op alone on the CPU (a
dispatch mode, so the exact normal's backward ops are moved too).  On an
NVIDIA H100 80GB HBM3 it read one t entry of 131072 off by 4.77e-7, the
plain version deterministic, and no op whose move brought it to 0: the
drift was not a device op but the order in which torch.autograd summed
`core.sdf.smin`'s four cotangents of h, another order than the kernels'
`grad_map` (tests/test_torch_grad_map_host.py).  Since `smin` creates
its ops in that order the banks are equal bit for bit
(tests/test_torch_cuda.py `test_record_exact_normal_nee_patch_at_zero`).
"""
import hashlib
import json

import pytest
import torch

from _torch_parity import (LATER_FRAC_OFF, MAX_FRAC_OFF, bank_parity,
                           cuda_device)  # noqa: F401
from test_torch_uv_witness import _one_ulp_up

from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.kernels.record import (record_plain,
                                                       trace_record_fused)
from raymarchrenderer_tpu_torch.render.config import RenderConfig
from raymarchrenderer_tpu_torch.scene import builtin

# (max_steps, seed) of the readings; the first is the fault's
CASES = ((192, 0), (192, 1), (512, 0))
_ORIGIN, _SHAPE, _SAMPLES = (11, 5), (37, 53), 2


def record(device, steps, seed, kernel=False, moved=()):
    """The recorder's banks on sphere_on_floor's patch: the kernel's (a
    CUDA `device`) or the plain version's, with the torch functions
    `moved` one ulp up."""
    scene = builtin.sphere_on_floor()
    params = scene.init_params(device)
    cfg = RenderConfig(width=96, height=64, max_steps=steps, max_bounces=4,
                       relax_omega=1.9, seed=seed)
    corners = Camera(eye=(0.0, 3.0, -7.0), aspect=1.5).corner_rays_flat(
        device)
    fn = trace_record_fused if kernel else record_plain
    saved = {f: getattr(torch, f) for f in moved}
    try:
        for f in moved:
            setattr(torch, f, _one_ulp_up(saved[f]))
        return fn(scene, params, cfg, corners, _ORIGIN, _SHAPE, 0,
                  n_samples=_SAMPLES)
    finally:
        for f, orig in saved.items():
            setattr(torch, f, orig)


def _meets_bar(p):
    return (p["decisions"] < MAX_FRAC_OFF and p["t"] < MAX_FRAC_OFF
            and p["t_later"] < LATER_FRAC_OFF)


@pytest.mark.parametrize("steps, seed", CASES[:2])
def test_one_ulp_of_sin_cos_stays_inside_the_bar(steps, seed):
    """The plain version against itself with sin and cos one ulp up, on
    the CPU: the same decisions and bounce-0 t, and the later bounces'
    drift (about 1%) well inside the 5% bar."""
    want = record("cpu", steps, seed)
    got = record("cpu", steps, seed, moved=("sin", "cos"))
    p = bank_parity(got, want, 0)
    assert p["decisions"] == 0.0 and p["t"] == 0.0, p
    assert 0.0 < p["t_later"] < LATER_FRAC_OFF, p


@pytest.mark.requires_cuda
def test_record_kernel_matches_card_plain_at_192_steps(cuda_device):
    """The recorder against its plain version on the card, at 192 steps,
    held to the banks' bar: once the plain version divided by Python
    numbers through torch's CUDA product with the reciprocal (5.25% of the
    later-bounce entries off); it divides as the kernel does now
    (`core.vecmath.div`)."""
    steps, seed = CASES[0]
    p = bank_parity(record(cuda_device, steps, seed, kernel=True),
                    record(cuda_device, steps, seed), 0)
    assert _meets_bar(p), p


@pytest.mark.requires_cuda
@pytest.mark.parametrize("steps, seed", CASES)
def test_record_kernel_matches_cpu_plain(cuda_device, steps, seed):
    """The recorder's banks against its plain version on the CPU, held to
    the banks' bar."""
    got = {k: v.cpu() for k, v in record(cuda_device, steps, seed,
                                         kernel=True).items()}
    p = bank_parity(got, record("cpu", steps, seed), 0)
    assert _meets_bar(p), p


# torch functions that move or make data without arithmetic: routing them
# to the CPU cannot change a value, so the bisection leaves them alone
_MOVES = {"__getitem__", "__setitem__", "to", "cpu", "cuda", "clone",
          "contiguous", "detach", "expand", "expand_as", "reshape", "view",
          "stack", "cat", "zeros_like", "ones_like", "full_like",
          "empty_like", "__get__", "dim", "size", "numel", "float", "int",
          "bool", "long", "item", "tolist", "__len__", "unsqueeze",
          "squeeze", "movedim", "permute", "flatten", "select"}


# float ops that select, clamp, flip a sign or make a tensor: exact on
# every device, so the bisection moves them only all together
_EXACT = {"torch.as_tensor", "torch.tensor", "torch.zeros", "torch.ones",
          "torch.full", "torch.clamp", "torch.abs", "torch.maximum",
          "torch.minimum", "torch.where", "torch.Tensor.neg"}


class _OpsOnCpu:
    """A torch function mode over the recorder's plain version on the
    card: `seen` gathers the functions that return floats; those named in
    `names` run on the CPU (inputs copied there, the outputs back), so a
    run with some of torch's CUDA ops replaced by their CPU builds shows
    which op carries the card's drift.  With `tensor_divisors`, a
    division by a Python number divides by that number as a tensor on
    the dividend's device instead."""

    def __init__(self, names=(), tensor_divisors=False):
        from torch.overrides import TorchFunctionMode, resolve_name
        from torch.utils._pytree import tree_map
        outer = self
        self.names, self.seen = set(names), {}

        def is_float(x):
            return isinstance(x, torch.Tensor) and x.is_floating_point()

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = resolve_name(func) or repr(func)
                if name.rsplit(".", 1)[-1] in _MOVES or name.endswith("_"):
                    return func(*args, **kwargs)
                if (tensor_divisors and name in (
                        "torch.Tensor.div", "torch.Tensor.__truediv__")
                        and isinstance(args[1], (int, float))):
                    args = (args[0], torch.tensor(float(args[1]),
                                                  device=args[0].device))
                if name in outer.names:
                    dev = next((x.device for x in (*args, *kwargs.values())
                                if isinstance(x, torch.Tensor)), None)
                    out = func(*tree_map(lambda x: x.cpu() if isinstance(
                        x, torch.Tensor) else x, args), **tree_map(
                        lambda x: x.cpu() if isinstance(x, torch.Tensor)
                        else x, kwargs))
                    out = tree_map(lambda x: x.to(dev) if isinstance(
                        x, torch.Tensor) else x, out)
                else:
                    out = func(*args, **kwargs)
                flat = out if isinstance(out, (tuple, list)) else (out,)
                if any(is_float(x) for x in flat):
                    outer.seen[name] = outer.seen.get(name, 0) + 1
                return out

        self.mode = Mode()


def bisect(steps, seed, device):
    """Which of torch's CUDA ops carries the plain recorder's drift from
    its CPU build: the card's plain run against the CPU's with no op, every
    float op, each op alone, and every op but one of the strongest moved
    to the CPU; one JSON line each (`t_later`: the later bounces' t
    entries off by more than 1e-4, as in the banks' bar)."""
    cpu = record("cpu", steps, seed)

    def run(names, tensor_divisors=False):
        ops = _OpsOnCpu(names, tensor_divisors)
        with ops.mode:
            got = record(device, steps, seed)
        if device.type == "cuda":
            torch.cuda.synchronize()
        p = bank_parity({k: v.cpu() for k, v in got.items()}, cpu, 0)
        return p, ops.seen

    base, seen = run(())
    names = sorted(seen, key=lambda n: -seen[n])
    print("record drift bisect: " + json.dumps(
        {"max_steps": steps, "seed": seed, "moved": "none",
         "t_later": base["t_later"], "float_ops": seen}), flush=True)
    every, _ = run(names)
    print("record drift bisect: " + json.dumps(
        {"moved": "every float op", "t_later": every["t_later"],
         "decisions": every["decisions"]}), flush=True)
    p = run((), tensor_divisors=True)[0]
    print("record drift bisect: " + json.dumps(
        {"moved": "none; every Python-number divisor a tensor on the card",
         "t_later": p["t_later"], "decisions": p["decisions"]}), flush=True)
    alone = {}
    for name in (n for n in names if n not in _EXACT):
        alone[name] = run((name,))[0]["t_later"]
        print("record drift bisect: " + json.dumps(
            {"moved": name, "calls": seen[name], "t_later": alone[name]}),
            flush=True)
    for name in sorted(alone, key=alone.get)[:2]:
        p = run([n for n in names if n != name])[0]
        print("record drift bisect: " + json.dumps(
            {"moved": f"every float op but {name}",
             "t_later": p["t_later"]}), flush=True)


# the exact-normal case of chip_smoke.py's parity_exact (the recorder #5 on
# csg_demo with NEE, a 128^2 patch at (384, 512) of the 1024^2 frame, 2
# samples, 4 bounces, relax 1.9, normal_taps 0)
EXACT_ORIGIN, EXACT_SHAPE = (384, 512), (128, 128)


def record_exact(device, kernel=False, size=1024, origin=EXACT_ORIGIN,
                 shape=EXACT_SHAPE):
    """The recorder's banks on the exact-normal NEE case: the kernel's (a
    CUDA `device`) or the plain version's."""
    scene = builtin.csg_demo()
    params = scene.init_params(device)
    cfg = RenderConfig(width=size, height=size, max_bounces=4,
                       relax_omega=1.9, normal_taps=0)
    corners = Camera(aspect=1.0).corner_rays_flat(device)
    fn = trace_record_fused if kernel else record_plain
    return fn(scene, params, cfg, corners, origin, shape, 0, n_samples=2,
              direct_light=True)


def _max_t_err(got, want):
    hit = (got["hit"] > 0) & (want["hit"] > 0)
    dt = torch.where(hit, (got["t"] - want["t"]).abs(), 0.0)
    return {"max_abs_t": float(dt.max()), "t_entries_off": int((dt > 0).sum()),
            "decisions_off": int(((got["mid"] != want["mid"])
                                  | (got["hit"] != want["hit"])).sum()),
            "sd_off": int((got["sd"] != want["sd"]).sum())}


# aten ops that only move, view, select or make data: the same bits on
# every device, so the exact bisection leaves them on the card
_ATEN_EXACT = {"where", "clone", "copy_", "_to_copy", "view", "expand",
               "select", "slice", "unsqueeze", "squeeze", "stack", "cat",
               "index", "index_put_", "full", "full_like", "zeros_like",
               "ones_like", "empty_like", "empty", "zeros", "ones", "fill_",
               "lift_fresh", "detach", "alias", "_unsafe_view", "permute",
               "t", "transpose", "reshape", "nonzero", "masked_fill",
               "scalar_tensor", "le", "lt", "ge", "gt", "eq", "ne",
               "logical_and", "logical_or", "logical_not", "bitwise_and",
               "bitwise_or", "bitwise_not", "bitwise_xor", "all", "any",
               "neg", "abs", "maximum", "minimum", "clamp", "sign",
               "new_zeros", "new_ones", "new_empty", "new_full",
               "_local_scalar_dense", "view_as_real", "as_strided", "sum",
               "is_nonzero"}


class _AtenOnCpu:
    """A torch dispatch mode over a plain run on the card: `seen` counts
    the aten ops that return floats (the backward of the exact normal's
    reverse sweep included, which a function mode does not see); those
    named in `names` run on the CPU, their inputs copied there and their
    outputs back."""

    def __init__(self, names=()):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_map
        outer = self
        self.names, self.seen = set(names), {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func._schema.name.split("::")[-1]
                if name in outer.names:
                    dev = next((x.device for x in (*args, *kwargs.values())
                                if isinstance(x, torch.Tensor)), None)

                    def cpu(x):
                        return x.cpu() if isinstance(x, torch.Tensor) else x
                    out = func(*tree_map(cpu, args), **tree_map(cpu, kwargs))
                    out = tree_map(lambda x: x.to(dev) if isinstance(
                        x, torch.Tensor) else x, out)
                else:
                    out = func(*args, **kwargs)
                flat = out if isinstance(out, (tuple, list)) else (out,)
                if any(isinstance(x, torch.Tensor) and x.is_floating_point()
                       for x in flat):
                    outer.seen[name] = outer.seen.get(name, 0) + 1
                return out

        self.mode = Mode()


def bisect_exact(device):
    """Which of torch's CUDA ops moves the plain recorder off the kernel on
    the exact-normal NEE case: the kernel against two plain runs (is the
    plain version deterministic?), then against the plain run with each
    float aten op alone on the CPU; an op whose move brings the banks to
    the kernel's is the one that computes otherwise on the card.  One JSON
    line each."""
    kern = record_exact(device, kernel=True)
    torch.cuda.synchronize()
    plains = [record_exact(device) for _ in range(2)]
    print("record exact bisect: " + json.dumps(
        {"kernel_vs_plain": _max_t_err(kern, plains[0]),
         "kernel_vs_plain_again": _max_t_err(kern, plains[1]),
         "plain_vs_plain": _max_t_err(plains[0], plains[1]),
         "kernel_banks_sha256": _digest(kern)}), flush=True)

    def run(names):
        ops = _AtenOnCpu(names)
        with ops.mode:
            got = record_exact(device)
        torch.cuda.synchronize()
        return _max_t_err(kern, got), ops.seen

    base, seen = run(())
    print("record exact bisect: " + json.dumps(
        {"moved": "none (under the mode)", **base, "float_ops": seen}),
        flush=True)
    for name in sorted(n for n in seen if n not in _ATEN_EXACT):
        err = run((name,))[0]
        print("record exact bisect: " + json.dumps(
            {"moved": name, "calls": seen[name], **err}), flush=True)


def _digest(banks):
    h = hashlib.sha256()
    for k in sorted(banks):
        h.update(banks[k].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


if __name__ == "__main__":
    import sys
    torch.set_num_threads(8)
    if "--bisect-exact" in sys.argv:
        bisect_exact(torch.device("cuda", 0))
        sys.exit(0)
    if "--bisect" in sys.argv:
        bisect(*CASES[0], torch.device("cuda", 0)
               if torch.cuda.is_available() else torch.device("cpu"))
        sys.exit(0)
    for steps, seed in CASES:
        cpu = record("cpu", steps, seed)
        line = {"max_steps": steps, "seed": seed}
        if torch.cuda.is_available():
            dev = torch.device("cuda", 0)
            kern = record(dev, steps, seed, kernel=True)
            card = record(dev, steps, seed)
            torch.cuda.synchronize()
            kern_cpu = {k: v.cpu() for k, v in kern.items()}
            card_cpu = {k: v.cpu() for k, v in card.items()}
            line.update({
                "card": torch.cuda.get_device_name(0),
                "kernel_vs_card_plain": bank_parity(kern, card, 0),
                "kernel_vs_cpu_plain": bank_parity(kern_cpu, cpu, 0),
                "card_plain_vs_cpu_plain": bank_parity(card_cpu, cpu, 0),
                "kernel_banks_sha256": _digest(kern)})
        else:
            line["cpu_plain_sin_cos_one_ulp_up"] = bank_parity(
                record("cpu", steps, seed, moved=("sin", "cos")), cpu, 0)
        print("record drift: " + json.dumps(line), flush=True)
