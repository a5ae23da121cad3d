"""The harness on the CPU: the names of `BENCHMARK.json`, the discovery
of new files, the modules a run loads, the refusal without a card, and
the check's verdict under the control and under planted faults.

A CPU run here skips the look for a card and drives the rest of a run
at a tiny size through the port's plain versions (`harness.Run` with a
device and overrides); the one test that needs the card is marked
`requires_cuda`."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from rmbench import faults, harness

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent
TINY = dict(width=8, height=8, spp=2, max_steps=64, max_bounces=3)
CELLS = ["spectral_sof.frames", "rgb_csg_nee.frames", "rgb_csg_nee.preview",
         "spectral_sof.train"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _doc():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _cpu_run(workload, seed=2**33 + 5, seconds=0.6, control=False,
             spec=None, **traffic):
    torch.set_num_threads(2)
    run = harness.Run(spec or harness.Spec(), workload, seed, trace=False,
                      device=torch.device("cpu"), cfg_overrides=TINY,
                      traffic_overrides=dict({"check_pixels": 24},
                                             **traffic))
    return harness.execute(run, seconds, time.perf_counter(), control)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_names_and_units_use_the_allowed_characters():
    doc = _doc()
    names = [c["name"] for c in doc["configs"]]
    names += [w["name"] for w in doc["workloads"]]
    names += [w[k] for w in doc["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    names += [k for c in doc["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for w in doc["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in doc["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_has_its_files():
    spec = harness.Spec()
    for w in _doc()["workloads"]:
        assert spec.config(w["config"])["scene"]
        assert spec.driver(spec.traffic(w["traffic"])["driver"]).check
        assert (ROOT / "limits" / f"{w['name']}.json").exists()


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and "out" not in p.parts}


def test_new_files_add_a_config_a_traffic_mix_and_a_metric(tmp_path):
    """A copy gains a configuration, a traffic mix, a cell and a
    per-layer metric by new files and new entries alone; no file the
    copy had changes, and a CPU run of the new cell reads the metric."""
    copy = tmp_path / "rmbench"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "out"))
    before = _digest(copy)
    conf = json.loads((copy / "configs" / "spectral_sof.json").read_text())
    conf["source"] = "a second deployment"
    (copy / "configs" / "spectral_copy.json").write_text(json.dumps(conf))
    (copy / "traffic" / "frames_few.json").write_text(json.dumps(
        {"driver": "frames", "check_pixels": 12}))
    (copy / "limits" / "spectral_copy.frames_few.json").write_text(
        (copy / "limits" / "spectral_sof.frames.json").read_text())
    (copy / "metrics" / "frames_done.count.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    doc = _doc()
    doc["configs"].append(dict(doc["configs"][0], name="spectral_copy",
                               file="rmbench/configs/spectral_copy.json"))
    doc["workloads"].append({"name": "spectral_copy.frames_few",
                             "config": "spectral_copy",
                             "traffic": "frames_few", "chips": 1,
                             "why": "a test cell"})
    for m in doc["end_to_end"]:
        if m["name"] == "render_msamples_s":
            m["workloads"].append("spectral_copy.frames_few")
    doc["per_layer"].append({"name": "frames_done.count", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "whole frame",
                             "moves": "render_msamples_s",
                             "workloads": ["spectral_copy.frames_few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    after = _digest(copy)
    assert all(after[k] == v for k, v in before.items())
    spec = harness.Spec(copy)
    assert spec.traffic("frames_few")["check_pixels"] == 12
    assert [m["name"] for m in spec.per_layer("spectral_copy.frames_few")] \
        == ["frames_done.count"]
    result = _cpu_run("spectral_copy.frames_few", spec=spec,
                      check_pixels=12)
    assert result["correct"]
    run = type("R", (), {"attempted": result["attempted"]})()
    assert spec.reader("frames_done.count").read(run) \
        == result["attempted"]


_PROBE = """
import json, sys, time, torch
from rmbench import faults, harness
run = harness.Run(harness.Spec(), {workload!r}, 11, trace=False,
                  device=torch.device("cpu"), cfg_overrides={tiny!r},
                  traffic_overrides={{"check_pixels": 8}})
harness.execute(run, 0.2, time.perf_counter())
print(json.dumps(sorted(sys.modules)))
"""


@pytest.mark.parametrize("workload", ["spectral_sof.frames",
                                      "rgb_csg_nee.preview"])
def test_a_run_loads_no_jax_and_no_jax_package(workload):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(workload=workload, tiny=TINY)],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(harness.FORBIDDEN), sorted(tops)
    assert "raymarchrenderer_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    probe = """
import json, sys, torch
from rmbench.reference import render
from rmbench.reference.config import RenderConfig
cfg = RenderConfig(width=8, height=8, max_steps=64, max_bounces=3)
text = open("rmbench/configs/rgb_csg_nee.scene").read()
ref = render.Reference(text, cfg, "rgb", True, "cpu")
ref.launch_pixels(render.corners(cfg, "cpu"), torch.tensor([1, 2]),
                  torch.tensor([3, 4]), torch.tensor([0, 2]), 2)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    tops = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not tops & {"jax", "jaxlib", "flax", "raymarchrenderer_tpu",
                       "raymarchrenderer_tpu_torch"}, sorted(tops)
    sources = "\n".join(p.read_text() for p in
                        (ROOT / "reference").glob("*.py"))
    assert "raymarchrenderer_tpu" not in re.sub(r"#.*", "", "\n".join(
        line for line in sources.splitlines()
        if line.lstrip().startswith(("import", "from"))))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raymarchrenderer_tpu_torchx", None)
    monkeypatch.setitem(sys.modules, "jaxish.sub", None)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raymarchrenderer_tpu.scene", None)
    assert harness.forbidden_modules() == ["raymarchrenderer_tpu.scene"]


def test_the_runner_refuses_a_machine_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "rmbench.run", "--workload",
         "spectral_sof.frames", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(REPO)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_cpu_run_is_correct(workload):
    result = _cpu_run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The reference at bfloat16 in the program's place fails a
    number."""
    assert not _cpu_run(workload, control=True)["correct"]


@pytest.mark.parametrize("fault", faults.KINDS["frames"])
@pytest.mark.parametrize("workload", ["spectral_sof.frames",
                                      "rgb_csg_nee.frames"])
def test_frames_faults_are_not_correct(workload, fault):
    """A frame that repeats the sequence's first samples (the state
    unchanged), a launch of half its samples, and one frame's values
    altered where the launch produces them."""
    with faults.plant("frames", fault):
        result = _cpu_run(workload, seconds=1.5)
    assert result["attempted"] >= 2
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.KINDS["preview"])
def test_preview_faults_are_not_correct(fault):
    """A merge that leaves the accumulator unchanged, passes that leave
    half the tiles out, and one tile launch of the window's first pass
    altered."""
    with faults.plant("preview", fault):
        result = _cpu_run("rgb_csg_nee.preview", check_pixels=64)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.KINDS["train"])
def test_train_faults_are_not_correct(fault):
    """Timed steps that leave the train state unchanged, and timed steps
    over half their samples, the set-up's steps left sound: the window's
    last step fails its numbers and the first steps pass theirs."""
    first = harness.Spec().traffic("train")["first_steps"]
    with faults.plant("train", fault, sound_calls=first):
        result = _cpu_run("spectral_sof.train", seconds=0.1)
    checks = result["checks"]
    assert not result["correct"], checks
    assert checks["loss_gap"]["value"] == 0.0
    assert checks["change_gap"]["value"] == 0.0
    assert (checks["last_loss_gap"]["value"] > checks["last_loss_gap"]["limit"]
            or checks["last_change_gap"]["value"]
            > checks["last_change_gap"]["limit"])


def test_driver_host_leaves_out_the_waits_on_the_card():
    """Each pass's span less the runtime calls inside it that wait for the
    card or copy to it, averaged over the passes (times in us)."""
    def ev(name, cat, ts, dur):
        return {"name": name, "cat": cat, "ts": ts, "dur": dur}
    host = [ev("rmbench.driver_host", "user_annotation", 0, 1000),
            ev("cudaMemcpyAsync", "cuda_runtime", 100, 50),
            ev("cudaStreamSynchronize", "cuda_runtime", 140, 300),
            ev("cudaLaunchKernel", "cuda_runtime", 500, 20),
            ev("rmbench.driver_host", "user_annotation", 2000, 500),
            ev("cudaStreamSynchronize", "cuda_runtime", 2400, 300)]
    run = type("R", (), {"tr": type("T", (), {"host": host})()})()
    reader = harness.Spec().reader("driver_host_ms.preview")
    # (1000 - 340) and (500 - 100) us
    assert reader.read(run) == pytest.approx((660 + 400) / 2 * 1e-3)


@pytest.mark.requires_cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "rmbench.run", "--workload",
         "spectral_sof.frames", "--seed", "4000000007", "--seconds", "2",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
