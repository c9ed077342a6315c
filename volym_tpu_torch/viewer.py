"""Interactive live viewer: a browser page served by a stdlib HTTP server.

Counterpart of :mod:`volym_tpu.viewer`, the analog of the reference's
interactive stack: the winit event loop (``src/event_loop.rs:94-157``), the
input routing in ``State`` (``src/state.rs:78-151``: drag = orbit, wheel =
zoom, P = screenshot) and the egui control panel (``src/gui.rs:132-280``:
camera XYZ readout and copy, mode checkboxes with their dependency rules,
ahead-steps / step-size / threshold sliders).  The "surface" is a browser
canvas: the server renders frames on demand and the page drives it.

The server is stateless: the client owns the camera and parameter state
and sends it with every ``/frame`` request, which makes the endpoints
testable without a browser.  Frames render through
:func:`volym_tpu_torch.render.renderer.make_renderer` (backends
``slab_cuda``, the default on a CUDA device, ``slab`` and ``ray``); an
unknown backend gets HTTP 400.  The PNG is encoded by
:func:`volym_tpu_torch.io.png_bytes` (the standard library's ``zlib``), so
no imaging library is needed.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from volym_tpu_torch import io as vio
from volym_tpu_torch.camera import Camera
from volym_tpu_torch.config import RenderParams
from volym_tpu_torch.render.renderer import BACKENDS, make_renderer

log = logging.getLogger("volym_tpu_torch")

_BOOL_FIELDS = (
    "use_shading",
    "use_gaussian_smoothing",
    "use_importance_coloring",
    "use_importance_rendering",
    "use_cone_importance_check",
    "use_opacity",
    "fast_math",
)


def params_from_query(q: dict, base: RenderParams) -> RenderParams:
    """Apply a /frame query dict onto ``base`` (the CLI-launch params).

    Dependency rules match the egui panel (``src/gui.rs:196-277``):
    importance rendering forces opacity on; the cone check only applies
    with importance rendering on."""
    kw = {}
    for f in _BOOL_FIELDS:
        if f in q:
            kw[f] = q[f][0] not in ("0", "false", "False")
    if "threshold" in q:
        kw["density_threshold"] = float(q["threshold"][0])
    if "step" in q:
        kw["raymarching_step_size"] = float(q["step"][0])
    if "ahead" in q:
        kw["importance_check_ahead_steps"] = int(float(q["ahead"][0]))
    if "interpolation" in q:
        kw["interpolation"] = q["interpolation"][0]
    p = base.replace(**kw)
    if p.use_importance_rendering and not p.use_opacity:
        p = p.replace(use_opacity=True)  # gui.rs: imp-rendering forces opacity
    if not p.use_importance_rendering and p.use_cone_importance_check:
        p = p.replace(use_cone_importance_check=False)
    return p


def camera_from_query(q: dict, aspect: float) -> Camera:
    """Client-owned orbit state -> Camera (reference ``src/camera.rs:47-61``
    clamps: vertical +-89 deg, distance [min, max])."""
    cam = Camera(
        aspect=aspect,
        horizontal_angle=float(q.get("h", ["30"])[0]),
        distance=1.0,
        min_distance=float(q.get("mind", ["1.0"])[0]),
        max_distance=float(q.get("maxd", ["10.0"])[0]),
    )
    # route through orbit() so the reference's clamping applies
    return cam.orbit(0.0, float(q.get("v", ["20"])[0]), float(q.get("dist", ["1.2"])[0]) - cam.distance)


class UnknownRenderer(ValueError):
    """A request names a renderer backend that does not exist (HTTP 400)."""


class RenderService:
    """Renders frames for (camera, params, backend) requests on ``device``,
    one at a time (the card is one queue, as the reference's one wgpu
    queue), through :func:`make_renderer`; ``backend`` is the default of a
    request that names none."""

    def __init__(self, scene, height: int, width: int, base_params: RenderParams, backend: str = "slab_cuda",
                 device="cuda"):
        self.scene = scene.to(device)
        self.height = height
        self.width = width
        self.base_params = base_params
        self.backend = backend
        self.device = device
        self.lock = threading.Lock()
        self.frames = 0

    def render(self, cam: Camera, params: RenderParams, backend: str, height: int | None = None,
               width: int | None = None):
        """-> (the (H, W, 4) float32 frame as a numpy array, ms).  The
        device-to-host fetch fences the frame; the ms is the host's clock
        around the render and the fetch.  The size defaults to the
        service's (the client sends its canvas size: live resize)."""
        height = self.height if height is None else height
        width = self.width if width is None else width
        with self.lock:
            t0 = time.perf_counter()
            render = make_renderer(self.scene, params, height, width, backend=backend, device=self.device)
            img = render(cam.matrices(device=self.device)).detach().cpu().numpy()
            ms = (time.perf_counter() - t0) * 1e3
            self.frames += 1
        return img, ms

    def png(self, img) -> bytes:
        return vio.png_bytes(img)


def size_from_query(q: dict, service: "RenderService") -> tuple[int, int]:
    """Per-request render size (live resize): clamped to [16, 2048] and
    rounded to a multiple of 8."""

    def one(key, default):
        v = int(float(q.get(key, [default])[0]))
        return max(16, min(2048, (v // 8) * 8))

    return one("ph", service.height), one("pw", service.width)


def make_handler(service: RenderService, screenshot_dir: str = "."):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log.debug("viewer: " + fmt, *args)

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _request(self, q):
            ph, pw = size_from_query(q, service)
            backend = q.get("renderer", [service.backend])[0]
            if backend not in BACKENDS:
                raise UnknownRenderer(f"unknown renderer {backend!r}; choose from {BACKENDS}")
            return camera_from_query(q, pw / ph), params_from_query(q, service.base_params), backend, ph, pw

        def do_GET(self):  # noqa: N802  (stdlib API name)
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == "/":
                    base = service.base_params
                    init = {
                        "width": service.width,
                        "height": service.height,
                        "renderer": service.backend,
                        "params": {f: bool(getattr(base, f)) for f in _BOOL_FIELDS} | {
                            "threshold": base.density_threshold,
                            "step": base.raymarching_step_size,
                            "ahead": base.importance_check_ahead_steps,
                        },
                    }
                    self._send(200, PAGE.replace("__INIT__", json.dumps(init)).encode(), "text/html; charset=utf-8")
                elif url.path == "/frame":
                    cam, params, backend, ph, pw = self._request(q)
                    img, ms = service.render(cam, params, backend, ph, pw)
                    png = service.png(img)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("X-Render-Ms", f"{ms:.3f}")
                    self.send_header("X-Camera-Pos", ",".join(f"{c:.4f}" for c in cam.position))
                    self.end_headers()
                    self.wfile.write(png)
                elif url.path == "/screenshot":
                    cam, params, backend, ph, pw = self._request(q)
                    img, _ = service.render(cam, params, backend, ph, pw)
                    path = vio.save_screenshot(img, screenshot_dir)
                    log.info("viewer screenshot: %s", path)
                    self._send(200, json.dumps({"path": str(path)}).encode(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except UnknownRenderer as e:
                self._send(400, str(e).encode(), "text/plain")
            except NotImplementedError as e:  # honest mode guards -> 422
                self._send(422, str(e).encode(), "text/plain")
            except BrokenPipeError:  # client dropped a stale frame request
                pass
            except Exception as e:  # surfaced to the page
                log.exception("viewer error")
                self._send(500, str(e).encode(), "text/plain")

    return Handler


def make_server(scene, params: RenderParams, height: int, width: int, host: str = "127.0.0.1", port: int = 8000,
                screenshot_dir: str = ".", backend: str = "slab_cuda", device="cuda") -> ThreadingHTTPServer:
    """Build (not start) the viewer HTTP server; ``port=0`` picks a free
    port (``server.server_address`` has the bound one)."""
    service = RenderService(scene, height, width, params, backend=backend, device=device)
    return ThreadingHTTPServer((host, port), make_handler(service, screenshot_dir))


def serve(scene, params, height, width, host="127.0.0.1", port=8000, screenshot_dir=".", backend="slab_cuda",
          device="cuda"):
    srv = make_server(scene, params, height, width, host, port, screenshot_dir, backend, device)
    log.info(
        "viewer at http://%s:%d/ (%dx%d) - drag orbits, wheel zooms, P saves a screenshot",
        *srv.server_address, width, height,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


# The control panel mirrors src/gui.rs:132-280 (the JAX package's page, the
# renderer list and its default the port's): camera readout + copy,
# renderer select, mode checkboxes (with the imp-rendering/cone/opacity
# dependency rules), ahead-steps 2-25, log step-size 0.001-0.1,
# threshold 0.005-1.0, plus an FPS readout (event_loop.rs:138-144).
PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>volym_tpu_torch viewer</title>
<style>
 body{margin:0;display:flex;font:13px system-ui;background:#111;color:#ddd}
 #view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
 img{image-rendering:pixelated;max-width:100%;max-height:100vh;cursor:grab}
 #panel{width:270px;padding:12px;background:#1b1b1f;overflow-y:auto}
 .row{margin:6px 0} label{display:inline-block;min-width:110px}
 input[type=range]{width:130px;vertical-align:middle}
 #cam,#stats{font-family:monospace;font-size:12px;color:#9c9}
 button{background:#333;color:#ddd;border:1px solid #555;border-radius:3px}
 h3{margin:8px 0 4px;font-size:13px;color:#fff}
</style></head><body>
<div id="view"><img id="frame" draggable="false"></div>
<div id="panel">
 <h3>volym_tpu_torch</h3>
 <div id="stats" class="row">render: – ms · fps –</div>
 <h3>Camera</h3>
 <div id="cam" class="row">–</div>
 <div class="row"><button id="copycam">copy position</button></div>
 <h3>Renderer</h3>
 <div class="row"><select id="renderer">
   <option value="slab_cuda">slab_cuda (CUDA kernels)</option>
   <option value="slab">slab (plain PyTorch)</option>
   <option value="ray">ray (t-step)</option>
 </select></div>
 <h3>Modes</h3>
 <div class="row"><label>shading</label><input type="checkbox" id="use_shading"></div>
 <div class="row"><label>gaussian</label><input type="checkbox" id="use_gaussian_smoothing"></div>
 <div class="row"><label>imp. coloring</label><input type="checkbox" id="use_importance_coloring"></div>
 <div class="row"><label>imp. rendering</label><input type="checkbox" id="use_importance_rendering"></div>
 <div class="row"><label>cone check</label><input type="checkbox" id="use_cone_importance_check"></div>
 <div class="row"><label>opacity</label><input type="checkbox" id="use_opacity"></div>
 <div class="row"><label>fast_math</label><input type="checkbox" id="fast_math"></div>
 <h3>Knobs</h3>
 <div class="row"><label>ahead steps</label><input type="range" id="ahead" min="2" max="25" step="1"><span id="aheadv"></span></div>
 <div class="row"><label>step size</label><input type="range" id="step" min="-3" max="-1" step="0.02"><span id="stepv"></span></div>
 <div class="row"><label>threshold</label><input type="range" id="threshold" min="0.005" max="1.0" step="0.005"><span id="thrv"></span></div>
 <div class="row" style="color:#888">drag = orbit · wheel = zoom · P = screenshot<br>
 every change re-renders; nothing compiles (PyTorch runs eagerly)</div>
</div>
<script>
const INIT = __INIT__;
let st = {h: 30, v: 20, dist: 1.2, renderer: INIT.renderer,
          ahead: INIT.params.ahead, step: INIT.params.step,
          threshold: INIT.params.threshold};
for (const f of ["use_shading","use_gaussian_smoothing","use_importance_coloring",
                 "use_importance_rendering","use_cone_importance_check",
                 "use_opacity","fast_math"]) {
  st[f] = INIT.params[f];
  const el = document.getElementById(f);
  el.checked = st[f];
  el.onchange = () => { st[f] = el.checked; applyRules(); request(); };
}
function applyRules() {  // src/gui.rs dependency rules
  const imp = document.getElementById("use_importance_rendering");
  const cone = document.getElementById("use_cone_importance_check");
  const op = document.getElementById("use_opacity");
  cone.disabled = !imp.checked;
  if (imp.checked) { op.checked = true; st.use_opacity = true; }
  st.use_cone_importance_check = cone.checked && imp.checked;
}
const frame = document.getElementById("frame");
const stats = document.getElementById("stats");
const camEl = document.getElementById("cam");
let pending = false, queued = false, lastT = performance.now(), lastPos = "";
let view = {w: INIT.width, h: INIT.height};
function fitView() {  // live resize: render at the canvas's own size
  const r = frame.getBoundingClientRect();
  const w = Math.max(64, Math.min(2048, Math.round(r.width / 8) * 8));
  const h = Math.max(64, Math.min(2048, Math.round(r.height / 8) * 8));
  if (w && h && (w !== view.w || h !== view.h)) {
    view = {w: w, h: h};
    return true;
  }
  return false;
}
let resizeT = null;
window.onresize = () => {  // gpu_context.rs:68-75 surface reconfigure
  clearTimeout(resizeT);
  resizeT = setTimeout(() => { if (fitView()) request(); }, 250);
};
function url(path) {
  const p = new URLSearchParams();
  p.set("pw", view.w); p.set("ph", view.h);
  p.set("h", st.h); p.set("v", st.v); p.set("dist", st.dist);
  p.set("renderer", st.renderer);
  p.set("ahead", st.ahead); p.set("step", st.step);
  p.set("threshold", st.threshold);
  for (const f of ["use_shading","use_gaussian_smoothing","use_importance_coloring",
                   "use_importance_rendering","use_cone_importance_check",
                   "use_opacity","fast_math"]) p.set(f, st[f] ? 1 : 0);
  return path + "?" + p.toString();
}
async function request() {
  if (pending) { queued = true; return; }
  pending = true;
  try {
    const r = await fetch(url("/frame"));
    if (r.ok) {
      const blob = await r.blob();
      frame.src = URL.createObjectURL(blob);
      const now = performance.now();
      stats.textContent = "render: " + (r.headers.get("X-Render-Ms")||"?") +
        " ms \\u00b7 fps " + (1000/(now-lastT)).toFixed(1);
      lastT = now;
      lastPos = r.headers.get("X-Camera-Pos") || "";
      camEl.textContent = "pos (" + lastPos + ")  h=" + st.h.toFixed(1) +
        "\\u00b0 v=" + st.v.toFixed(1) + "\\u00b0 d=" + (+st.dist).toFixed(2);
    } else { stats.textContent = await r.text(); }
  } finally {
    pending = false;
    if (queued) { queued = false; request(); }
  }
}
let drag = null;
frame.onmousedown = e => { drag = [e.clientX, e.clientY]; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {  // state.rs:120-139 drag-to-orbit
  if (!drag) return;
  st.h += (e.clientX - drag[0]) * 0.5;
  st.v = Math.max(-89, Math.min(89, st.v + (e.clientY - drag[1]) * 0.5));
  drag = [e.clientX, e.clientY];
  request();
};
frame.onwheel = e => {  // state.rs:141-148 wheel-to-zoom
  e.preventDefault();
  st.dist = Math.max(1.0, Math.min(10.0, st.dist + e.deltaY * 0.002));
  request();
};
window.onkeydown = e => {  // state.rs:85-113 P = screenshot
  if (e.key === "p" || e.key === "P")
    fetch(url("/screenshot")).then(r => r.json())
      .then(j => { stats.textContent = "saved " + j.path; });
};
document.getElementById("copycam").onclick = () =>
  navigator.clipboard.writeText(lastPos);
document.getElementById("renderer").onchange = e => {
  st.renderer = e.target.value; request();
};
for (const [id, key, show] of [["ahead","ahead", v=>v],
    ["step","step", v=>(+v).toFixed(3)], ["threshold","threshold", v=>(+v).toFixed(3)]]) {
  const el = document.getElementById(id), lab = document.getElementById(
    id === "threshold" ? "thrv" : id + "v");
  if (id === "step") el.value = Math.log10(st.step);
  else el.value = st[key];
  lab.textContent = show(st[key]);
  el.oninput = () => {
    st[key] = id === "step" ? Math.pow(10, +el.value) : +el.value;
    lab.textContent = show(st[key]);
    request();
  };
}
document.getElementById("renderer").value = st.renderer;
applyRules();
request();
</script></body></html>
"""
