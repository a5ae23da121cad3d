"""Interactive viewer: the GUI frontend of the port, the JAX package's
`app/viewer.py` on the port's renders.

The reference's GUI (`GUI.cpp:181-321`) is an SFGUI desktop panel over the
live accumulation texture: a Render button, samples / image W/H / grid W/H
entries, a scene path, right-drag pan and wheel zoom of the image
(`GUI.cpp:328-364`).  As in the JAX package, the equivalent is a
dependency-free HTTP viewer: a worker thread drives the progressive loop
and a stdlib `http.server` serves

  * ``/``              — the control panel and canvas page (the same page),
  * ``/api/state``     — render progress JSON (poll-driven redraw),
  * ``/api/image.png`` — the current accumulation, sRGB-encoded,
  * ``/api/render``    — POST: (re)start with scene / spp / size / grid,
  * ``/api/camera``    — POST: orbit / pan / zoom / reset / look_at, then
                         restart (a pose op before any render only moves
                         the pose),
  * ``/api/stop``      — POST: cancel, keeping the partial image
                         (Escape, `Program.cpp:188-194`),
  * ``/api/scenes``    — builtins and the data/scenes listing
                         (`GUI.cpp:7-34`).

On a card (`device="cuda"`, the default) a spectral render runs
`render_progressive_fused_spectral` in launches of 4 samples, cancelled
from its callback; an RGB render runs `render_progressive_fused` in
launches of 4, with NEE when asked, cancelled the same way; a scene with an env image takes the
deferred-sky kernel, as the CLI does.  The kernel is built (`prepare`)
before the first launch, so an nvcc build shows as `rendering` at n = 0.
After each launch the running mean is copied to the host under the lock.
On `device="cpu"` the plain renders run sample by sample (`render`,
`render_spectral`), cancelled from their per-sample callback.  A kernel
that fails to build or launch is reported in `/api/state`'s `error`; it is
never replaced by the plain version.  `stop` joins the worker, so one
render's launches have ended before the next one starts.

Run: ``python -m raymarchrenderer_tpu_torch viewer --port 8000``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from raymarchrenderer_tpu_torch.app.cli import BUILTIN_SCENES, build_scene
from raymarchrenderer_tpu_torch.core.camera import Camera
from raymarchrenderer_tpu_torch.io.image import png_bytes

_CHUNK = 4         # samples per launch of a render on the card

_PAGE = """<!doctype html>
<html><head><title>raymarch viewer</title><style>
body { font-family: system-ui, sans-serif; margin: 0; display: flex;
       height: 100vh; background: #16161d; color: #ddd; }
#panel { width: 240px; padding: 12px; background: #1f1f28; }
#panel label { display: block; margin: 8px 0 2px; font-size: 12px;
               color: #aab; }
#panel input, #panel select { width: 100%; box-sizing: border-box;
  background: #2a2a35; color: #eee; border: 1px solid #444; padding: 4px; }
#panel button { margin-top: 12px; width: 100%; padding: 8px;
  background: #4a6; color: #fff; border: 0; cursor: pointer; }
#panel button.stop { background: #a55; }
#status { margin-top: 10px; font-size: 12px; color: #8c8; }
#view { flex: 1; overflow: hidden; position: relative; cursor: grab; }
canvas { position: absolute; image-rendering: pixelated; }
</style></head><body>
<div id="panel">
  <b>raymarch renderer</b>
  <label>scene</label><select id="scene"></select>
  <label>samples</label><input id="spp" type="number" value="64">
  <label>image width</label><input id="w" type="number" value="512">
  <label>image height</label><input id="h" type="number" value="512">
  <label>grid w×h</label><input id="grid" value="4x4">
  <label>max bounces</label><input id="bounces" type="number" value="8">
  <label>env map (.hdr path, optional)</label><input id="env" value="">
  <label><input id="spectral" type="checkbox" style="width:auto">
    spectral (gen-3 wavelength transport)</label>
  <label><input id="nee" type="checkbox" style="width:auto">
    direct light (NEE soft shadows)</label>
  <button id="render">Render</button>
  <button id="stop" class="stop">Stop</button>
  <button id="camreset">Reset camera</button>
  <div id="status">idle</div>
  <div style="margin-top:10px;font-size:11px;color:#889">
    drag: pan canvas · wheel: zoom canvas<br>
    shift-drag: orbit · ctrl-drag: pan camera · ctrl-wheel: dolly</div>
</div>
<div id="view"><canvas id="cv"></canvas></div>
<script>
const cv = document.getElementById('cv'), view = document.getElementById('view');
let zoom = 1, ox = 20, oy = 20, drag = null, lastN = -1;
function place() { cv.style.transform = `scale(${zoom})`;
  cv.style.transformOrigin = '0 0';
  cv.style.left = ox + 'px'; cv.style.top = oy + 'px'; }
let camdrag = null;
const camOp = o => fetch('api/camera',
  { method: 'POST', body: JSON.stringify(o) }).then(() => lastN = -1);
view.onmousedown = e => {
  if (e.shiftKey || e.ctrlKey) { camdrag = [e.clientX, e.clientY, e.ctrlKey]; }
  else { drag = [e.clientX - ox, e.clientY - oy]; } };
window.onmousemove = e => { if (drag) { ox = e.clientX - drag[0];
  oy = e.clientY - drag[1]; place(); } };
window.onmouseup = e => {
  if (camdrag) {  // one op per gesture: each op restarts the accumulation
    const dx = e.clientX - camdrag[0], dy = e.clientY - camdrag[1];
    if (camdrag[2]) camOp({ op: 'pan', dx: -dx * 0.01, dy: dy * 0.01 });
    else camOp({ op: 'orbit', ax: -dx * 0.005, ay: -dy * 0.005 });
    camdrag = null; }
  drag = null; };
view.onwheel = e => { e.preventDefault();
  if (e.ctrlKey) { camOp({ op: 'zoom', amount: -Math.sign(e.deltaY) * 0.5 }); }
  else { zoom *= Math.pow(1.1, -Math.sign(e.deltaY)); place(); } };
document.getElementById('camreset').onclick = () => camOp({ op: 'reset' });
async function refresh() {
  const st = await (await fetch('api/state')).json();
  document.getElementById('status').textContent =
    (st.rendering ? 'rendering ' : 'idle ') + st.n.toFixed(0) + '/' + st.spp
    + ' spp' + (st.error ? ' — ' + st.error : '');
  if (st.n !== lastN && st.n > 0) {
    lastN = st.n;
    const img = new Image();
    img.onload = () => { cv.width = img.width; cv.height = img.height;
      cv.getContext('2d').drawImage(img, 0, 0); place(); };
    img.src = 'api/image.png?n=' + st.n;
  }
}
setInterval(refresh, 700);
(async () => {
  const sc = await (await fetch('api/scenes')).json();
  const sel = document.getElementById('scene');
  for (const s of sc) { const o = document.createElement('option');
    o.textContent = s; sel.appendChild(o); } })();
document.getElementById('render').onclick = async () => {
  lastN = -1;
  const g = document.getElementById('grid').value.split('x');
  await fetch('api/render', { method: 'POST', body: JSON.stringify({
    scene: document.getElementById('scene').value,
    spp: +document.getElementById('spp').value,
    width: +document.getElementById('w').value,
    height: +document.getElementById('h').value,
    grid_width: +g[0] || 4, grid_height: +g[1] || 4,
    max_bounces: +document.getElementById('bounces').value,
    env_map: document.getElementById('env').value || null,
    spectral: document.getElementById('spectral').checked,
    direct_light: document.getElementById('nee').checked })});
};
document.getElementById('stop').onclick = () =>
  fetch('api/stop', { method: 'POST' });
</script></body></html>"""


class _Cancelled(Exception):
    """Raised from a render's callback to end a cancelled render."""


class ViewerState:
    """The progressive render's shared state, driven by one worker thread
    on `device` (the card by default; "cpu" for the plain versions)."""

    def __init__(self, scene_dirs=("data/scenes",), device="cuda"):
        self.lock = threading.Lock()
        self.device = torch.device(device)
        self.accum = None          # (H, W, 3) float32 linear (numpy)
        self.n = 0.0
        self.spp = 0
        self.rendering = False
        self.error = ""
        self.scene_dirs = scene_dirs
        self.camera = None         # persistent interactive pose
        self._last_req = {}        # re-rendered on camera ops
        self._ever_started = False  # camera ops before the first render
        #                             only pose: they must not launch one
        self._cancel = threading.Event()
        self._thread = None
        # serialises start / stop across the server's request threads
        self._control = threading.RLock()

    # -- scene listing (GUI.cpp:7-34 directory scan) -------------------------
    def scenes(self):
        names = list(BUILTIN_SCENES)
        for d in self.scene_dirs:
            if os.path.isdir(d):
                names += sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(".scene"))
        return names

    # -- render control ------------------------------------------------------
    def start(self, req: dict):
        with self._control:
            self.stop()
            self._last_req = dict(req)
            self._ever_started = True
            # each render has its own cancel flag: a flag cleared for the
            # next render can never revive the last one
            self._cancel = cancel = threading.Event()
            with self.lock:
                # mark the restart synchronously: the worker takes a while
                # to build the scene (and nvcc a kernel), and a client
                # polling /api/state in that window must not read the
                # previous render's finished (n, rendering=False) as this
                # one's
                self.rendering = True
                self.n = 0.0
            self._thread = threading.Thread(
                target=self._run, args=(req, cancel), daemon=True)
            self._thread.start()

    # -- interactive camera (Camera.cpp:104-137: the reference wired
    # zoom / pan / orbit but commented its input handling out; here each op
    # moves the persistent pose and restarts the accumulation at 0 spp) ----
    def camera_op(self, op: dict) -> dict:
        with self.lock:
            if self.camera is None:
                self.camera = Camera()
            cam = self.camera
            kind = op.get("op", "")
            if kind == "orbit":
                cam.orbit(float(op.get("ax", 0.0)), float(op.get("ay", 0.0)))
            elif kind == "pan":
                cam.pan(float(op.get("dx", 0.0)), float(op.get("dy", 0.0)))
            elif kind == "zoom":
                cam.zoom(float(op.get("amount", 0.0)))
            elif kind == "reset":
                self.camera = cam = Camera(aspect=cam.aspect)
            elif kind == "look_at":
                cam.look_at(tuple(op.get("target", (0.0, 0.0, 0.0))))
            else:
                raise ValueError(f"unknown camera op: {kind!r}")
            pose = {"eye": list(cam.eye), "direction": list(cam.direction)}
            req = dict(self._last_req) if self._ever_started else None
        if req is not None:
            # restart the progressive buffer under the new pose
            self.start(req)
        # before any render only the pose moves: no unrequested render of
        # the default scene is launched
        return pose

    def stop(self):
        """Cancel the render and wait for its thread: its last launch has
        ended and been copied out before this returns, so the next render
        never shares the device or `accum` with it."""
        with self._control:
            self._cancel.set()
            if self._thread is not None:
                self._thread.join()
            with self.lock:
                self.rendering = False

    def _publish(self, state, cancel) -> None:
        """Copy a launch's running mean to the host under the lock; then
        end the render if it was cancelled."""
        with self.lock:
            self.accum = state[0].cpu().numpy()
            self.n = float(state[1])
        if cancel.is_set():
            raise _Cancelled

    def _run(self, req: dict, cancel: threading.Event):
        try:
            with (torch.cuda.device(self.device)
                  if self.device.type == "cuda" else contextlib.nullcontext()):
                self._render(req, cancel)
        except _Cancelled:
            pass
        except (Exception, SystemExit) as e:   # surfaces in `error` (a
            # SystemExit is `build_scene`'s refusal of an unknown scene)
            traceback.print_exc()
            with self.lock:
                self.error = f"{type(e).__name__}: {e}"
        finally:
            with self.lock:
                self.rendering = False

    def _render(self, req: dict, cancel: threading.Event):
        from raymarchrenderer_tpu_torch.kernels import march
        from raymarchrenderer_tpu_torch.render.config import RenderConfig

        dev = self.device
        scene = build_scene(req.get("scene", "sphere_on_floor"),
                            req.get("env_map"))
        params = scene.init_params(dev)
        cfg = RenderConfig(
            width=int(req.get("width", 512)),
            height=int(req.get("height", 512)),
            spp=int(req.get("spp", 64)),
            max_steps=int(req.get("max_steps", 256)),
            max_bounces=int(req.get("max_bounces", 8)),
            max_dist=float(req.get("max_dist", 1000.0)),
            grid_width=int(req.get("grid_width", 4)),
            grid_height=int(req.get("grid_height", 4)))
        with self.lock:
            if self.camera is None:
                self.camera = Camera(aspect=cfg.width / cfg.height)
            else:
                self.camera.aspect = cfg.width / cfg.height
            corners = self.camera.corner_rays_flat(dev)
            self.accum = np.zeros((cfg.height, cfg.width, 3), np.float32)
            self.n = 0.0
            self.spp = cfg.spp
            self.rendering = True
            self.error = ""
        spectral = bool(req.get("spectral"))
        direct_light = bool(req.get("direct_light"))
        cuda = dev.type == "cuda"
        if cuda:
            # nvcc (when the library is not built yet) shows as
            # `rendering` at n = 0, not as a hang of the first launch
            march.prepare(dev, march.MEGA_SPECTRAL if spectral else (
                march.MEGA_PATHS_DEFER if scene.has_env_map
                else march.MEGA_PATHS))

        def publish(s, state):         # after each launch, or sample
            self._publish(state, cancel)

        if spectral:
            from raymarchrenderer_tpu_torch.render.spectral_integrator import (
                band_table, render_spectral)
            mats = band_table(scene, dev)
            if cuda:
                march.render_progressive_fused_spectral(
                    scene, params, mats, cfg, corners, spp=cfg.spp,
                    samples_per_launch=_CHUNK, callback=publish)
            else:
                render_spectral(scene, params, mats, cfg, corners,
                                spp=cfg.spp, callback=publish)
            return
        if cuda:
            # the megakernel for every RGB workload: NEE in-loop, an env
            # image through the deferred sky, as the CLI renders them
            march.render_progressive_fused(
                scene, params, cfg, corners, spp=cfg.spp,
                samples_per_launch=_CHUNK, direct_light=direct_light,
                callback=publish)
            return
        from raymarchrenderer_tpu_torch.render.integrator import render
        render(scene, params, cfg, corners, spp=cfg.spp,
               direct_light=direct_light, callback=publish)

    # -- encoded outputs -----------------------------------------------------
    def png_bytes(self) -> bytes:
        with self.lock:
            img = None if self.accum is None else self.accum.copy()
        if img is None:
            img = np.zeros((16, 16, 3), np.float32)
        return png_bytes(img)  # in memory: no temporary file per poll

    def state_json(self) -> bytes:
        with self.lock:
            cam = self.camera
            return json.dumps({
                "rendering": self.rendering, "n": self.n, "spp": self.spp,
                "width": 0 if self.accum is None else self.accum.shape[1],
                "height": 0 if self.accum is None else self.accum.shape[0],
                "camera": None if cam is None else {
                    "eye": list(cam.eye),
                    "direction": list(cam.direction)},
                "error": self.error}).encode()


def make_server(port: int = 8000, host: str = "127.0.0.1",
                state: ViewerState = None,
                device="cuda") -> ThreadingHTTPServer:
    """The viewer's HTTP server over `state` (a new `ViewerState` on
    `device` when None); port 0 takes a free port
    (`server_address[1]`)."""
    st = state or ViewerState(device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, fn):
            try:
                self._send(json.dumps({"ok": True, **(fn() or {})}).encode(),
                           "application/json")
            except (ValueError, TypeError, KeyError) as e:
                self._send(json.dumps(
                    {"ok": False, "error": str(e)}).encode(),
                    "application/json", 400)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif path == "/api/state":
                self._send(st.state_json(), "application/json")
            elif path == "/api/image.png":
                self._send(st.png_bytes(), "image/png")
            elif path == "/api/scenes":
                self._send(json.dumps(st.scenes()).encode(),
                           "application/json")
            else:
                self._send(b"not found", "text/plain", 404)

        def do_POST(self):
            path = self.path.split("?")[0]
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b"{}"
            if path == "/api/render":
                self._send_json(lambda: st.start(json.loads(body or b"{}")))
            elif path == "/api/camera":
                self._send_json(lambda: st.camera_op(
                    json.loads(body or b"{}")))
            elif path == "/api/stop":
                self._send_json(st.stop)
            else:
                self._send(b"not found", "text/plain", 404)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.viewer_state = st
    return srv


def serve(port: int = 8000, host: str = "127.0.0.1", device="cuda") -> None:
    """Serve the viewer until interrupted, rendering on `device`."""
    srv = make_server(port, host, device=device)
    print(f"viewer at http://{host}:{srv.server_address[1]}/ "
          f"(rendering on {srv.viewer_state.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.viewer_state.stop()
        srv.server_close()
