"""Interactive browser viewer (port of :mod:`rtgs_tpu.viewer.server`).

A dependency-free ``http.server`` serving one page: the browser sends
orbit-camera events (drag = pan, right-drag = move the 3D cursor, wheel =
zoom, three sliders = global scene rotation) to ``/event``; the server runs
them through :class:`~rtgs_tpu_torch.viewer.orbit.OrbitState`, renders a
frame through :func:`rtgs_tpu_torch.render.api.render` on the scene's
device, and answers ``/frame`` with a PNG. A frame is rendered once per
pose: without jitter every sample of a pose is the same image. The default
renderer, ``auto``, resolves as ``render`` resolves it: above 4096 splats
on a CUDA device that is the fused kernel (``pallas``).

Unlike the JAX ``serve``, the CLI's tile-path knobs (``--max-candidates``,
``--tile-bands``, ``--bin-narrow``) reach the renderer (``render_kwargs``),
as they do for the port's ``render`` and ``fit``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

logger = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><title>rtgs-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px; }
img { display:block; margin:auto; image-rendering:pixelated; }
input[type=range] { width: 140px; }
</style></head><body>
<div id="hud">
  rtgs-tpu viewer — drag: orbit, right-drag: cursor, wheel: zoom<br>
  Rot X <input type="range" id="rx" min="0" max="6.283" step="0.017" value="0">
  Rot Y <input type="range" id="ry" min="0" max="6.283" step="0.017" value="0">
  Rot Z <input type="range" id="rz" min="0" max="6.283" step="0.017" value="0">
  <span id="stat"></span>
</div>
<img id="view" src="/frame?v=0">
<script>
const img = document.getElementById('view');
let v = 0, busy = false, queued = null;
async function send(ev) {
  if (busy) { queued = ev; return; }
  busy = true;
  const t0 = performance.now();
  await fetch('/event', {method:'POST', body: JSON.stringify(ev)});
  img.src = '/frame?v=' + (++v);
  img.onload = () => {
    document.getElementById('stat').textContent =
      ' ' + Math.round(performance.now() - t0) + ' ms';
    busy = false;
    if (queued) { const q = queued; queued = null; send(q); }
  };
}
let drag = null;
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => {
  drag = {x: e.clientX, y: e.clientY, btn: e.button}; e.preventDefault();
});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = (e.clientX - drag.x) / img.width;
  const dy = -(e.clientY - drag.y) / img.height;
  drag.x = e.clientX; drag.y = e.clientY;
  send({type: drag.btn === 2 ? 'move' : 'pan', dx, dy});
});
img.addEventListener('wheel', e => {
  e.preventDefault(); send({type:'zoom', delta: e.deltaY > 0 ? -1 : 1});
});
for (const id of ['rx','ry','rz']) {
  document.getElementById(id).addEventListener('input', () => send({
    type:'rot',
    rx:+document.getElementById('rx').value,
    ry:+document.getElementById('ry').value,
    rz:+document.getElementById('rz').value}));
}
</script></body></html>"""


class ViewerSession:
    """Render-on-demand session shared by the HTTP handler threads.

    ``lock`` is held around each event and each render: a render reads the
    pose, and the first one on the card builds the kernels' library, which
    two handler threads must not do at once. ``timings`` holds the last
    rendered frame's seconds: ``render`` (the render, the copy to the host
    and the conversion to uint8) and ``encode`` (PNG)."""

    def __init__(self, g, res, fov, depth, renderer="auto",
                 render_kwargs=None):
        from rtgs_tpu_torch.viewer.orbit import OrbitState

        self.g = g
        self.res = res
        self.fov = fov
        self.depth = depth
        self.renderer = renderer
        self.render_kwargs = render_kwargs or {}
        self.state = OrbitState()
        self.lock = threading.Lock()
        self.timings = {}
        self._frame = None

    def handle_event(self, ev: dict):
        with self.lock:
            t = ev.get("type")
            if t == "pan":
                self.state.pan(ev["dx"], ev["dy"])
            elif t == "move":
                self.state.move_cursor(ev["dx"], ev["dy"])
            elif t == "zoom":
                self.state.zoom(float(ev["delta"]))
            elif t == "rot":
                self.state.set_global_rotation(
                    ev["rx"], ev["ry"], ev["rz"])
            self._frame = None

    def frame_png(self) -> bytes:
        with self.lock:
            if self._frame is None:
                self._frame = self._render()
            return self._frame

    def camera(self):
        from rtgs_tpu_torch.camera import camera_from_fov

        pos, rot = self.state.camera_pose()
        return camera_from_fov(pos, rot, self.res, self.fov,
                               device=self.g.device)

    def _render(self) -> bytes:
        from rtgs_tpu_torch.camera import image_to_display
        from rtgs_tpu_torch.render.api import render
        from rtgs_tpu_torch.utils.image import encode_png, to_uint8

        t0 = time.perf_counter()
        # inference_mode is per thread: this runs on a handler thread.
        with torch.inference_mode():
            img = render(self.g, self.camera(), depth=self.depth,
                         renderer=self.renderer, **self.render_kwargs)
            arr = to_uint8(image_to_display(img).cpu().numpy())
        t1 = time.perf_counter()
        png = encode_png(arr)
        self.timings = {"render": t1 - t0,
                        "encode": time.perf_counter() - t1}
        return png


def make_server(g, args, render_kwargs=None):
    """The viewer's ``ThreadingHTTPServer`` on ``args.port`` (all
    interfaces) and its :class:`ViewerSession`, not yet serving. ``args``
    carries the CLI's ``res``, ``fov``, ``depth``, ``renderer`` and
    ``radius``."""
    session = ViewerSession(
        g, res=args.res, fov=args.fov, depth=args.depth,
        renderer=args.renderer, render_kwargs=render_kwargs)
    session.state.r = args.radius

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame"):
                data = session.frame_png()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE.encode())

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(length) or b"{}")
                session.handle_event(ev)
            except (ValueError, KeyError, TypeError) as e:
                self.send_response(400)
                self.end_headers()
                self.wfile.write(str(e).encode())
                return
            self.send_response(204)
            self.end_headers()

    return ThreadingHTTPServer(("0.0.0.0", args.port), Handler), session


def serve(g, args, render_kwargs=None):
    """Entry point of the ``serve`` CLI command: serve until interrupted
    (``args.port`` 0 takes a free port; the printed address names it)."""
    server, _ = make_server(g, args, render_kwargs)
    print(f"viewer: http://localhost:{server.server_address[1]}  "
          f"({g.num} splats, {args.res[0]}x{args.res[1]})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
