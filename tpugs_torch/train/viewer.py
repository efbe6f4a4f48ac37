"""Live training viewer — browser view of a training run. Counterpart:
``tpugs/train/viewer.py``, host-side; frames are encoded as PNG by
``io/images.py::encode_png`` (``cv2``).

The reference runs a viser/nerfview web viewer alongside training
(``f3dgs/simple_trainer_feature_3dgs.py:403-409,928-947``): a browser
shows the scene rendered from a user-controlled camera while the model
trains, plus a steps/s readout. viser is a heavy websocket stack; here,
as in tpugs, a dependency-free HTTP server:

* ``GET /``           — HTML page that polls the frame + stats
* ``GET /frame.png``  — latest render (PNG)
* ``GET /stats.json`` — step, losses, num_GS, steps/s, rays/s
* ``POST /camera``    — orbit-camera request ``{"yaw","pitch","radius"}``
  (the page's drag/scroll controls post here; the trainer renders the
  requested view at its next update)

The trainer drives it: every ``viewer_every`` steps it calls
``viewer.render_request()`` to get the user's camera (or None for the
default view), renders one frame host-side, and pushes it with
``viewer.update(...)``. Rendering happens on the training device
between steps — the nerfview "train/render budget" dance collapses to
a cadence knob.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from tpugs_torch.io.images import encode_png

_PAGE = """<!doctype html>
<html><head><title>tpugs live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:1em}
#stats{white-space:pre;margin:0.6em 0}
img{border:1px solid #444;max-width:95vw;image-rendering:pixelated}
</style></head><body>
<h3>tpugs training</h3>
<div id="stats">connecting…</div>
<img id="frame" src="/frame.png" draggable="false">
<div>drag: orbit &nbsp; wheel: dolly</div>
<script>
let yaw=null,pitch=0.3,radius=null,drag=null;
const img=document.getElementById('frame');
img.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];e.preventDefault()});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag)return;
  if(yaw===null){yaw=0}
  yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.01;
  pitch=Math.max(-1.4,Math.min(1.4,pitch));
  drag=[e.clientX,e.clientY]; post();
});
img.addEventListener('wheel',e=>{
  if(radius===null)radius=3.0;
  radius*=Math.exp(e.deltaY*0.001); post(); e.preventDefault();
});
function post(){
  fetch('/camera',{method:'POST',body:JSON.stringify(
    {yaw:yaw===null?0:yaw,pitch:pitch,radius:radius===null?3.0:radius})});
}
setInterval(()=>{
  fetch('/stats.json').then(r=>r.json()).then(s=>{
    document.getElementById('stats').textContent=
      Object.entries(s).map(([k,v])=>k+': '+
        (typeof v==='number'?v.toPrecision(5):v)).join('\\n');
  }).catch(()=>{});
  img.src='/frame.png?t='+Date.now();
},1000);
</script></body></html>
"""


class LiveViewer:
    """Threaded HTTP viewer. ``port=0`` picks a free port (tests)."""

    def __init__(self, port: int = 8080, host: str = "0.0.0.0"):
        self._lock = threading.Lock()
        self._png: Optional[bytes] = None
        self._stats: dict = {}
        self._camera: Optional[dict] = None
        self._t_start = time.time()
        self._last = (0, self._t_start)  # (step, time) for steps/s

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/stats.json":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/camera":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    cam = json.loads(self.rfile.read(n) or b"{}")
                    cam = {
                        "yaw": float(cam.get("yaw", 0.0)),
                        "pitch": float(cam.get("pitch", 0.0)),
                        "radius": float(cam.get("radius", 3.0)),
                    }
                except (ValueError, TypeError):
                    self._send(400, "text/plain", b"bad camera json")
                    return
                with viewer._lock:
                    viewer._camera = cam
                self._send(200, "application/json", b"{}")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------ trainer side
    def render_request(self) -> Optional[dict]:
        """Camera the browser asked for (``{"yaw","pitch","radius"}``),
        or None if the user hasn't touched the controls."""
        with self._lock:
            return dict(self._camera) if self._camera else None

    def update(self, step: int, stats: dict, frame_uint8=None,
               num_rays_per_step: int = 0):
        """Push latest stats (+ optional HxWx3 uint8 frame)."""
        now = time.time()
        s0, t0 = self._last
        steps_per_s = (step - s0) / max(now - t0, 1e-9) if step > s0 else 0.0
        self._last = (step, now)
        merged = {
            "step": step,
            **{k: float(v) for k, v in stats.items()},
            "steps_per_s": round(steps_per_s, 3),
            "elapsed_s": round(now - self._t_start, 1),
        }
        if num_rays_per_step:
            merged["rays_per_s"] = round(steps_per_s * num_rays_per_step, 1)
        png = encode_png(frame_uint8) if frame_uint8 is not None else None
        with self._lock:
            self._stats = merged
            if png is not None:
                self._png = png

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def orbit_viewmat(center: np.ndarray, yaw: float, pitch: float,
                  radius: float) -> np.ndarray:
    """World-to-camera 4x4 for an orbit camera looking at ``center``
    (same turntable convention as the interactive viewer app)."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    eye = center + radius * np.array([cy * cp, sp, sy * cp])
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows: camera axes in world
    vm = np.eye(4)
    vm[:3, :3] = R
    vm[:3, 3] = -R @ eye
    return vm.astype(np.float32)
