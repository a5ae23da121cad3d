"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name `BENCHMARK.json`
gives it:

  * `configs/<config>.json` — the render settings and the scene file
    (`configs/<config>.scene`, the scene's text, which the program and
    the reference each parse with their own parser);
  * `traffic/<traffic>.json` — the mix's parameters, with `driver`, the
    name of the general loop in `drivers/<driver>.py` that reads them;
  * `metrics/<metric>.py` — a per-layer metric's reader, `read(run)`,
    which returns a number or None (nothing to read: the metric is left
    out of the line);
  * `limits/<workload>.json` — the limits of the cell's check.

A driver module has `setup(run)`, `warm(run)`, `window(run, seconds)`
and `check(run, control)`; it reads the program through the `_torch`
package alone and the reference through `rmbench.reference` alone.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from rmbench.check import judge, load_limits
from rmbench.trace import Trace, profiled

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
OUT = ROOT / "out"
# top-level module names no run may have loaded once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "raymarchrenderer_tpu")


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def load_module(path: Path, name: str):
    """Import the file `path` as module `name` (metric names hold dots,
    so their readers load by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """`BENCHMARK.json` and the files it names."""

    def __init__(self, root: Path = ROOT, spec_path: Path = None):
        self.root = Path(root)
        path = spec_path or self.root.parent / "BENCHMARK.json"
        self.doc = json.loads(Path(path).read_text())

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((self.root.parent / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.root / "traffic" / f"{name}.json").read_text())

    def driver(self, name: str):
        return load_module(self.root / "drivers" / f"{name}.py",
                           f"rmbench_driver_{name}")

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.doc["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [workload])
                and m["moves"] in moves]

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py",
                           "rmbench_metric_" + metric.replace(".", "_"))


def seed32(seed: int) -> int:
    """The render configuration's 32-bit seed of a run's `--seed`."""
    return int(seed) % (1 << 32)


def pick_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """`count` distinct pixel indices of a frame, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels),
                              replace=False))


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of `FORBIDDEN`,
    compared as whole names."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_info() -> dict:
    """`nvidia-smi`'s name and power limit of each card (empty where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"power_limit": out[0].split(",")[-1].strip()} if out else {}


def _cache_dirs() -> None:
    """Every kernel cache inside the checkout, at fixed paths (the port
    builds its libraries into `build/raymarchrenderer_tpu_torch/` there
    by itself)."""
    base = REPO / "build" / "rmbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


class Run:
    """The state of one run, handed to the driver and to the readers.

    `cfg_overrides` and `device` are for the CPU tests, which drive a
    run at a tiny size through the port's plain versions."""

    def __init__(self, spec: Spec, workload: str, seed: int, trace: bool,
                 device=None, cfg_overrides=None, traffic_overrides=None):
        self.spec = spec
        self.workload = workload
        self.cell = spec.workload(workload)
        self.config = spec.config(self.cell["config"])
        self.traffic = dict(spec.traffic(self.cell["traffic"]),
                            **(traffic_overrides or {}))
        self.seed = int(seed)
        self.trace = trace
        self.device = device
        self.cfg_overrides = dict(cfg_overrides or {})
        self.e2e = {}          # end-to-end metric -> value
        self.work = {}         # the reference's counts, scaled
        self.attempted = 0
        self.failed = 0
        self.readings = {}     # check number -> value
        self.window_s = None
        self.tr = None         # the parsed trace, with --trace 1

    def scene_text(self) -> str:
        return (self.spec.root / "configs"
                / self.config["scene"]).read_text()

    def render_settings(self, job=None) -> dict:
        """The RenderConfig fields of the configuration, with a job's own
        settings (`job`), the run's seed and the test overrides."""
        settings = dict(self.config["render"], **(job or {}))
        settings["seed"] = seed32(self.seed)
        settings.update(self.cfg_overrides)
        return settings


def _require_card(chips: int):
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: this benchmark measures the port on "
                     "the card and never on the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, "
                     f"{torch.cuda.device_count()} are visible")


def execute(run: Run, seconds: float, t_start: float,
            control: bool = False) -> dict:
    """Set up, warm, measure for `seconds`, check; returns the result
    line's object.  `t_start` is the process's first instant on the
    host's clock (the start of `setup_s`)."""
    cuda = run.device is None
    if cuda:
        _require_card(run.cell["chips"])
        _cache_dirs()
        run.device = torch.device("cuda", 0)
        torch.cuda.set_device(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    driver = run.spec.driver(run.traffic["driver"])
    driver.setup(run)
    driver.warm(run)
    if cuda:
        torch.cuda.synchronize(run.device)
    setup_s = time.perf_counter() - t_start
    trace_path = None
    if run.trace:
        OUT.mkdir(parents=True, exist_ok=True)
        trace_path = OUT / f"{run.workload}-{run.seed}.trace.json"
        # the per-layer metrics are means per frame, pass or step: a
        # traced window of `trace_seconds` keeps the trace to tens of MB
        seconds = min(seconds, float(run.traffic.get("trace_seconds",
                                                     seconds)))
        with profiled(trace_path):
            driver.window(run, seconds)
    else:
        driver.window(run, seconds)
    peak = int(torch.cuda.max_memory_allocated(run.device)) if cuda else 0
    driver.check(run, control)
    limits = load_limits(run.workload, run.spec.root)
    correct = judge(run.readings, limits)
    metrics = {}
    if run.trace:
        run.tr = Trace(trace_path)
        for m in run.spec.per_layer(run.workload):
            value = run.spec.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        run.e2e["setup_s"] = setup_s
        for m in run.spec.end_to_end(run.workload):
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": float(run.e2e[m["name"]]),
                                      "unit": m["unit"]}
    result = {
        "correct": bool(correct), "attempted": int(run.attempted),
        "failed": int(run.failed), "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device) if cuda
                            else "cpu"),
                   "count": int(run.cell["chips"]),
                   "memory_peak_bytes": peak},
    }
    if cuda:
        result["device"].update(card_info())
    if run.trace:
        result["device"]["busy_s"] = run.tr.busy_s
        result["device"]["window_s"] = run.tr.window_s
        result["breakdown"] = {"device_ops": run.tr.device_ops(),
                               "idle_gaps": run.tr.idle_gaps()}
    result["setup_seconds"] = setup_s
    result["checks"] = {k: {"value": run.readings.get(k), "limit": v}
                        for k, v in limits.items()}
    return result
