"""The port's viewer (`app.viewer`) through its HTTP surface on the CPU
(`make_server(port=0, device="cpu")`, a free port per test): the page and
the scene listing, progress and the image, stop keeping the partial
accumulation, the spectral and NEE modes, camera operations restarting
the render, `reset` giving the first image's bytes again, and a camera
operation before the first render launching nothing (the JAX package's
tests/test_viewer.py, on the port).

Against the JAX package: the final `accum` of one viewer request, and the
image of one repl session, each within the image bar of
`_torch_parity.frac_off` (fewer than 1e-3 of the values off by more than
1e-5).  Both sides render with their plain oracles (16^2 to 32^2, 1-2
samples, at most 64 steps for the viewer; the repl's fixed 512 steps and
16 bounces at 32^2, 1 sample).
"""
import argparse
import io
import json
import shutil
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_parity import MAX_FRAC_OFF, frac_off

from raymarchrenderer_tpu_torch.app.viewer import ViewerState, make_server

torch.set_num_threads(1)

_REQ = {"scene": "sphere_on_floor", "spp": 2, "width": 32, "height": 32,
        "max_steps": 48, "max_bounces": 2, "max_dist": 100.0}


@pytest.fixture()
def server():
    srv = make_server(port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield base, srv.viewer_state
    srv.viewer_state.stop()
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.read()


def _post(base, path, obj=None):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj or {}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _wait_done(base, n, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = json.loads(_get(base, "/api/state"))
        if st["n"] >= n and not st["rendering"]:
            return st
        time.sleep(0.1)
    raise AssertionError(f"render did not finish: {st}")


def _png(base):
    from raymarchrenderer_tpu_torch.io.image import load_png_bytes
    return load_png_bytes(_get(base, "/api/image.png"))


def test_page_and_scene_listing(server):
    base, _ = server
    page = _get(base, "/").decode()
    assert "Render" in page and "canvas" in page and "api/camera" in page
    scenes = json.loads(_get(base, "/api/scenes"))
    assert scenes[:6] == ["sphere_on_floor", "single_sphere", "csg",
                          "cornell", "glass", "volume"]
    assert any(s.endswith("default.scene") for s in scenes)
    with pytest.raises(urllib.error.HTTPError):
        _get(base, "/nope")


def test_render_progress_and_image(server):
    base, state = server
    assert json.loads(_post(base, "/api/render", {**_REQ, "spp": 3}))["ok"]
    st = _wait_done(base, 3)
    assert st["error"] == "" and st["n"] == 3.0 and st["spp"] == 3
    assert (st["width"], st["height"]) == (32, 32)
    assert _get(base, "/api/image.png")[:8] == b"\x89PNG\r\n\x1a\n"
    assert state.accum.shape == (32, 32, 3) and state.accum.mean() > 0.0


def test_stop_preserves_partial(server):
    base, state = server
    _post(base, "/api/render", {**_REQ, "spp": 500})
    deadline = time.time() + 120
    while time.time() < deadline:
        if json.loads(_get(base, "/api/state"))["n"] >= 1:
            break
        time.sleep(0.05)
    _post(base, "/api/stop")
    st = json.loads(_get(base, "/api/state"))
    assert not st["rendering"] and 1 <= st["n"] < 500
    assert not state._thread.is_alive()        # stop joined the worker
    time.sleep(0.2)
    assert json.loads(_get(base, "/api/state"))["n"] == st["n"]


@pytest.mark.parametrize("mode", [{"spectral": True},
                                  {"direct_light": True}],
                         ids=["spectral", "nee"])
def test_spectral_and_nee_render_modes(server, mode):
    base, _ = server
    _post(base, "/api/render", {**_REQ, "width": 24, "height": 24, **mode})
    st = _wait_done(base, 2)
    assert st["error"] == "" and st["n"] == 2.0


def test_bad_request_is_reported(server):
    """A failure in the worker (a scene that does not exist) surfaces in
    the state's `error`; a malformed camera op is a 400."""
    base, _ = server
    _post(base, "/api/render", {**_REQ, "scene": "no_such_scene"})
    st = _wait_done(base, 0)
    assert "no_such_scene" in st["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/api/camera", {"op": "spin"})
    assert e.value.code == 400


def test_camera_ops_restart_render(server):
    """orbit / zoom / pan move the persistent pose and restart the
    accumulation under it, so the image changes; `reset` restores the
    exact pose, and the image's bytes are the first render's."""
    base, _ = server
    _post(base, "/api/render", _REQ)
    st = _wait_done(base, 2)
    img_a, eye0 = _png(base), st["camera"]["eye"]
    r = json.loads(_post(base, "/api/camera",
                         {"op": "orbit", "ax": 0.4, "ay": 0.0}))
    assert r["ok"] and r["direction"] != st["camera"]["direction"]
    _wait_done(base, 2)
    assert not np.array_equal(img_a, _png(base)), "orbit must change it"
    r = json.loads(_post(base, "/api/camera", {"op": "zoom", "amount": 1.0}))
    assert r["ok"] and r["eye"] != eye0
    _wait_done(base, 2)
    r = json.loads(_post(base, "/api/camera", {"op": "pan", "dx": 0.2,
                                               "dy": -0.1}))
    assert r["ok"]
    _wait_done(base, 2)
    r = json.loads(_post(base, "/api/camera", {"op": "reset"}))
    assert r["ok"] and r["eye"] == [0.0, 4.0, -6.0]
    _wait_done(base, 2)
    assert np.array_equal(img_a, _png(base)), "reset restores the pose"


def test_camera_op_before_first_render_does_not_launch(server):
    base, state = server
    r = json.loads(_post(base, "/api/camera",
                         {"op": "orbit", "ax": 0.3, "ay": 0.1}))
    assert r["ok"] and len(r["eye"]) == 3
    time.sleep(0.2)
    st = json.loads(_get(base, "/api/state"))
    assert not st["rendering"] and st["n"] == 0
    assert state._thread is None, "a camera op launched a render"
    _post(base, "/api/render", {**_REQ, "spp": 1, "width": 16,
                                "height": 16})
    st = _wait_done(base, 1)
    assert st["camera"]["direction"] == r["direction"]


def test_concurrent_restarts_never_overlap_renders():
    """Many request threads restarting the render at once (start, camera
    ops, stop; the switch interval shortened): at most one render runs at
    any moment, and after the last stop none does."""
    state = ViewerState(device="cpu")
    live, peak, guard = [0], [0], threading.Lock()
    render = state._render

    def counted(req, cancel):
        with guard:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        try:
            render(req, cancel)
        finally:
            with guard:
                live[0] -= 1
    state._render = counted
    req = {**_REQ, "width": 8, "height": 8, "spp": 3, "max_steps": 16}

    def client(k):
        for i in range(6):
            if (k + i) % 3 == 0:
                state.start(req)
            elif (k + i) % 3 == 1:
                state.camera_op({"op": "orbit", "ax": 0.01, "ay": 0.0})
            else:
                state.stop()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    state.stop()
    assert peak[0] == 1 and live[0] == 0
    assert state._thread is not None and not state._thread.is_alive()
    assert not state.rendering and state.error == ""


def _run_state(state, req, timeout=300):
    state.start(req)
    state._thread.join(timeout=timeout)
    assert not state._thread.is_alive()
    assert state.error == "", state.error
    return state.accum.copy(), state.n


@pytest.mark.parametrize("req", [
    {**_REQ, "width": 24, "height": 24, "max_steps": 64},
    {**_REQ, "width": 16, "height": 16, "max_steps": 64, "spectral": True},
], ids=["rgb", "spectral"])
def test_viewer_accum_matches_jax(req):
    """One request through the JAX viewer's state and the port's (`cpu`):
    the final accumulations within the image bar."""
    from raymarchrenderer_tpu.app.viewer import ViewerState as JViewerState
    want, jn = _run_state(JViewerState(), req)
    got, tn = _run_state(ViewerState(device="cpu"), req)
    assert jn == tn == 2.0 and got.shape == want.shape
    assert got.mean() > 0.0
    assert frac_off(want, got) < MAX_FRAC_OFF


def test_repl_image_matches_jax(tmp_path, monkeypatch, capsys):
    """The same repl session through both CLIs (32^2, 1 sample, a 2 x 2
    grid, the repl's 512 steps and 16 bounces); the PNGs decoded.  The JAX
    repl renders into a fixed file under the system's temporary directory,
    which other tests and checkouts write too: here its `save_image` and
    the `shutil.copy` of its `save` go to a file under `tmp_path`."""
    import raymarchrenderer_tpu.io as jio
    from raymarchrenderer_tpu.app import cli as jcli
    from raymarchrenderer_tpu.io.image import load_png
    from raymarchrenderer_tpu_torch.app import cli as tcli
    session = ("samples 1\nimage_width 32\nimage_height 32\ngrid_width 2\n"
               "grid_height 2\nload_scene csg\nrender\nsave {}\nquit\n")
    jout, tout = tmp_path / "jax.png", tmp_path / "torch.png"
    moved = {}
    save_image, copy = jio.save_image, shutil.copy

    def local_save(path, img, *a, **k):
        moved[path] = str(tmp_path / "jax_render.png")
        return save_image(moved[path], img, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(jio, "save_image", local_save)
        m.setattr(shutil, "copy",
                  lambda src, dst: copy(moved[str(src)], dst))
        m.setattr(sys, "stdin", io.StringIO(session.format(jout)))
        assert jcli.cmd_repl(argparse.Namespace()) == 0
    assert len(moved) == 1
    monkeypatch.setattr(sys, "stdin", io.StringIO(session.format(tout)))
    assert tcli.cmd_repl(argparse.Namespace(device="cpu")) == 0
    assert capsys.readouterr().out.count("4/4") == 2
    want, got = load_png(str(jout)), load_png(str(tout))
    assert got.shape == (32, 32, 3) and got.mean() > 0.0
    assert frac_off(want, got) < MAX_FRAC_OFF
