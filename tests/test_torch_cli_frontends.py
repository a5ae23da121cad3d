"""The port's CLI frontends: `main` returns the verb's exit code (the
repair: it returned 0 whatever the verb said), every command line of the
JAX parser parses, `--cache-dir` / `--no-cache` move the kernels' library
directory (and `RAYMARCH_NO_CACHE`, which tests/conftest.py sets, does
not), `info` prints the JAX CLI's JSON, `bench` prints `bench.py`'s keys,
`repl` speaks the reference's verbs, and `render --metrics` / `--profile`
write the JAX CLI's JSONL events and a `torch.profiler` trace.

`info` is compared equal, key for key and value for value, on the six
builtins and every data/scenes/*.scene; `render --metrics` compiles the
JAX CLI's oracle render once (16^2, 1 sample, 32 steps) and its events and
keys are compared equal, and the values that are not timings.
"""
import argparse
import glob
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from raymarchrenderer_tpu_torch.app import cli as tcli

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = ["--width", "16", "--height", "16", "--spp", "1", "--max-steps",
         "32", "--max-bounces", "2"]


def test_main_returns_the_verbs_exit_code(monkeypatch, capsys):
    """A failed parity gate is a non-zero exit (JAX `app/cli.py` returns
    `args.fn(args)`); `info` exits 0, and `render`, which returns its
    image to in-process callers, 0."""
    from raymarchrenderer_tpu_torch.utils import parity
    calls = []

    def failing(**kw):
        calls.append(kw)
        return 1
    monkeypatch.setattr(parity, "run_parity", failing)
    assert tcli.main(["parity", "--device", "cpu"]) == 1
    assert calls and calls[0]["device"] == torch.device("cpu")
    assert tcli.main(["info", "--scene", "csg"]) == 0
    capsys.readouterr()


def test_render_through_main_exits_zero(tmp_path):
    assert tcli.main(["render", "--cpu", *_TINY, "--out",
                      str(tmp_path / "x.npy")]) == 0
    assert (tmp_path / "x.npy").exists()


def test_module_entry_propagates_exit_codes(tmp_path):
    """`python -m raymarchrenderer_tpu_torch parity --device cpu` exits
    with the gate's code (run_parity patched to fail, the module run as
    `-m` runs it); `info` exits 0; an unknown verb is argparse's 2."""
    code = ("import runpy, sys; "
            "import raymarchrenderer_tpu_torch.utils.parity as p; "
            "p.run_parity = lambda **kw: 3; "
            "sys.argv = ['raymarchrenderer_tpu_torch', 'parity', "
            "'--device', 'cpu']; "
            "runpy.run_module('raymarchrenderer_tpu_torch', "
            "run_name='__main__', alter_sys=True)")
    env = dict(os.environ, PYTHONPATH=_REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 3, r.stderr
    r = subprocess.run([sys.executable, "-m", "raymarchrenderer_tpu_torch",
                        "info"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert set(json.loads(r.stdout)) == {"materials", "objects", "lights",
                                         "env_map", "differentiable_params"}
    r = subprocess.run([sys.executable, "-m", "raymarchrenderer_tpu_torch",
                        "definitely-not-a-verb"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2


# every subcommand and global flag of the JAX parser
# (raymarchrenderer_tpu/app/cli.py:514-564), as a JAX user types them
JAX_COMMAND_LINES = [
    ["--no-cache", "render", "--cpu", "--scene", "csg", "--direct-light",
     "--width", "32", "--height", "32", "--spp", "2", "--metrics", "m.jsonl",
     "--profile", "prof", "--checkpoint", "c.npz", "--resume", "--chunk",
     "2", "--impl", "oracle", "--relax", "1.9", "--normal-taps", "4",
     "--eye", "0", "4", "-6", "--look-at", "0", "0", "0", "--fov", "0.8",
     "--seed", "3", "--max-dist", "100", "--out", "o.png"],
    ["--cache-dir", "D", "render", "--spectral", "--env-map", "s.hdr"],
    ["--no-cache", "train", "--cpu", "--target", "t.npy", "--steps", "2",
     "--lr", "0.1", "--impl", "fused", "--spectral", "--metrics", "m",
     "--profile", "p", "--checkpoint", "c", "--resume"],
    ["bench", "--size", "16", "--spp", "1", "--impl", "oracle"],
    ["bench"],
    ["info"],
    ["info", "--scene", "data/scenes/default.scene"],
    ["repl"],
    ["parity"],
    ["viewer", "--port", "0"],
    ["viewer", "--port", "8000", "--host", "0.0.0.0"],
]


@pytest.mark.parametrize("argv", JAX_COMMAND_LINES,
                         ids=[" ".join(a[:3]) for a in JAX_COMMAND_LINES])
def test_jax_command_lines_parse(argv):
    args = tcli.build_parser().parse_args(argv)
    verb = next(a for a in argv if not a.startswith("-") and a != "D")
    assert args.cmd == verb
    assert args.no_cache == ("--no-cache" in argv)
    assert args.cache_dir == ("D" if "--cache-dir" in argv else None)
    if verb in ("render", "train"):
        assert args.cpu == ("--cpu" in argv)
    if verb == "bench" and "--size" not in argv:
        assert (args.size, args.spp, args.impl) == (1024, 8, "auto")
    if verb == "viewer":
        assert args.port in (0, 8000) and args.device == "cuda"


def test_cache_dir_moves_the_library_directory(tmp_path, monkeypatch,
                                               capsys):
    """`--cache-dir D` builds into and loads from D for the verb;
    `--no-cache` a temporary directory, gone after it; the default
    stays `build/raymarchrenderer_tpu_torch/` under RAYMARCH_NO_CACHE=1."""
    from raymarchrenderer_tpu_torch.kernels import build, march
    seen = []
    real_info = tcli.cmd_info

    def info(args):
        seen.append(march.MEGA_PATHS.library_path().parent)
        return real_info(args)
    monkeypatch.setattr(tcli, "cmd_info", info)
    monkeypatch.setenv("RAYMARCH_NO_CACHE", "1")
    default = march.MEGA_PATHS.library_path().parent
    assert default == build.BUILD_DIR == build.library_dir()
    assert tcli.main(["--cache-dir", str(tmp_path / "k"), "info"]) == 0
    assert tcli.main(["--no-cache", "info"]) == 0
    assert tcli.main(["info"]) == 0
    capsys.readouterr()
    assert seen[0] == tmp_path / "k"
    assert seen[1] not in (default, tmp_path / "k")
    assert not seen[1].exists()
    assert seen[2] == default == build.library_dir()
    assert march.MEGA_PATHS.library_path().name.startswith("mega_paths-")


@pytest.mark.parametrize("scene", [
    "sphere_on_floor", "single_sphere", "csg", "cornell", "glass", "volume",
    *sorted(glob.glob(os.path.join(_REPO, "data", "scenes", "*.scene")))],
    ids=lambda s: os.path.basename(s))
def test_info_matches_jax(scene, capsys):
    from raymarchrenderer_tpu.app import cli as jcli
    assert jcli.cmd_info(argparse.Namespace(scene=scene)) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcli.main(["info", "--scene", scene]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want


_BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "wall_s", "spp",
               "relax_omega", "normal_taps", "dispersion"}
# bench.py's profile keys but `vpu_utilization_est` (a TPU VPU peak)
_PROFILE_KEYS = {"rays_per_s", "map_evals_per_s", "segments_per_sample",
                 "march_map_evals_per_sample", "hits_per_sample",
                 "map_evals_per_sample", "profile_samples",
                 "march_occupancy", "occupancy_tiles", "occupancy_spp"}


@pytest.mark.parametrize("profile", ["1", "0"])
def test_bench_prints_bench_py_keys(profile, monkeypatch, capsys):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_PROFILE", profile)
    assert tcli.main(["bench", "--size", "16", "--spp", "1", "--impl",
                      "oracle", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    want = _BENCH_KEYS | (_PROFILE_KEYS if profile == "1" else set())
    assert set(got) == want
    assert got["metric"] == ("Mpix*spp/s @ 16x16 (impl=oracle, "
                             "platform=cpu)")
    assert got["spp"] == 1 and got["value"] > 0 and got["unit"] == \
        "Mpix*spp/s"
    assert (got["relax_omega"], got["normal_taps"]) == (2.0, 4)


@pytest.mark.parametrize("knob", ["BENCH_DIRECT", "BENCH_ENV",
                                  "BENCH_DISPERSION"])
def test_bench_refuses_rgb_knobs_in_spectral_mode(knob, monkeypatch):
    monkeypatch.setenv(knob, "1")
    monkeypatch.delenv("BENCH_MODE", raising=False)
    with pytest.raises(SystemExit, match=f"{knob}=1 requires BENCH_MODE=rgb"):
        tcli.main(["bench", "--size", "16", "--spp", "1", "--impl", "oracle",
                   "--device", "cpu"])


def test_repl_render_and_save(tmp_path, monkeypatch, capsys):
    """The reference REPL session (JAX tests/test_cli.py): samples, size,
    a 2 x 2 grid (4 spiral tiles), render, save, an unknown verb."""
    out = tmp_path / "repl.npy"
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "samples 1\nimage_width 32\nimage_height 32\ngrid_width 2\n"
        f"grid_height 2\nrender\nsave {out}\nbogus_verb 1\nquit\n"))
    assert tcli.cmd_repl(argparse.Namespace(device="cpu")) == 0
    text = capsys.readouterr().out
    assert "unknown verb: bogus_verb" in text
    assert "tile (" in text and "4/4" in text and "render time:" in text
    import numpy as np
    img = np.load(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0


def test_repl_save_before_render_and_bad_grid(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "save\nimage_width 30\ngrid_width 4\nrender\nsamples x\nquit\n"))
    assert tcli.main(["repl", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "nothing rendered" in text
    assert "bad arguments for render" in text      # 30 % 4: the reference's
    assert "bad arguments for samples" in text     # integer-division limit


def test_render_metrics_matches_jax(tmp_path):
    from raymarchrenderer_tpu.app import cli as jcli
    jm, tm = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jcli.main(["--no-cache", "render", "--cpu", *_TINY, "--metrics",
                      str(jm), "--out", str(tmp_path / "j.png")]) == 0
    assert tcli.main(["--no-cache", "render", "--cpu", *_TINY, "--metrics",
                      str(tm), "--out", str(tmp_path / "t.png")]) == 0
    want = [json.loads(x) for x in jm.read_text().splitlines()]
    got = [json.loads(x) for x in tm.read_text().splitlines()]
    assert [e["event"] for e in got] == [e["event"] for e in want] == [
        "render_start", "render_done"]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in ("event", "width", "height", "spp", "impl", "platform"):
            assert g.get(k) == w.get(k), k
    assert got[1]["wall_s"] >= 0 and got[1]["mpix_spp_per_s"] >= 0


def test_render_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert tcli.main(["render", "--cpu", "--spectral", *_TINY, "--profile",
                      str(prof), "--out", str(tmp_path / "o.png")]) == 0
    capsys.readouterr()
    traces = sorted(prof.glob("trace-*.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
