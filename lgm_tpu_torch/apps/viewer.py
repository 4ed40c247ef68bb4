"""Interactive Gaussian splat viewer (web-based).

Port of ``lgm_tpu/apps/viewer.py``, the replacement for the reference's
DearPyGui viewer (ref: gui.py:18-294): a stdlib HTTP server renders one
view per request (``render_views`` with dup 32: one launch of kernel K2 a
frame on the card) and a small HTML page gives mouse orbit, pan, scroll
zoom and sliders. The render time of each frame is measured on the server
(ending in a device synchronize) and sent in an ``X-Render-Ms`` header;
the page overlays ms and FPS (ref: gui.py:100-104).

Frames are JPEG through OpenCV where ``cv2`` imports, as in lgm_tpu, and
PNG through the port's own writer (``io/png.py``) otherwise; the
``Content-Type`` says which, and the page shows either.

Run: python -m lgm_tpu_torch.apps.viewer model.ply [--port 7860]
         [--size 512] [--device cuda]
"""

from __future__ import annotations

import argparse
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np
import torch

from lgm_tpu_torch.infer import resolve_device
from lgm_tpu_torch.io import png
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.utils import camera

_PAGE = """<!doctype html>
<html><head><title>lgm_tpu viewer</title><style>
 body { margin:0; background:#111; color:#eee; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#0008; padding:6px; }
 #view { display:block; margin:auto; cursor:grab; }
 label { margin-right: 12px; }
</style></head><body>
<div id="hud">
  <div id="stats">-</div>
  <label>mode <select id="mode"><option>image</option><option>alpha</option>
  <option>depth</option></select></label>
  <label>fovy <input id="fovy" type="range" min="20" max="90" value="49.1"
   step="0.1"></label>
  <label>scale <input id="scale" type="range" min="0.05" max="2" value="1"
   step="0.05"></label>
</div>
<img id="view" width="__SIZE__" height="__SIZE__"/>
<script>
let el=0, az=0, radius=1.5, busy=false, drag=0, lx=0, ly=0, pan=[0,0];
const img=document.getElementById('view');
const stats=document.getElementById('stats');
async function refresh(){
  if(busy) return; busy=true;
  const t0=performance.now();
  const q=new URLSearchParams({el:el,az:az,radius:radius,
    panx:pan[0],pany:pan[1],
    fovy:document.getElementById('fovy').value,
    scale:document.getElementById('scale').value,
    mode:document.getElementById('mode').value});
  const r=await fetch('/render?'+q);
  const ms=r.headers.get('X-Render-Ms');
  const b=await r.blob();
  img.src=URL.createObjectURL(b);
  const total=performance.now()-t0;
  stats.textContent=`render ${Number(ms).toFixed(2)}ms `+
    `(${(1000/Number(ms)).toFixed(0)} FPS) | round-trip `+
    `${total.toFixed(0)}ms | el ${el.toFixed(1)} az ${az.toFixed(1)} `+
    `r ${radius.toFixed(2)}`;
  busy=false;
}
img.onmousedown=e=>{
  drag=(e.button===2||e.button===1||e.shiftKey)?2:1;
  lx=e.clientX;ly=e.clientY;e.preventDefault();};
img.oncontextmenu=e=>e.preventDefault();
window.onmouseup=()=>drag=0;
window.onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-lx, dy=e.clientY-ly;
  if(drag===2){ // pan: right/middle/shift-drag, like gui.py:219-243
    const s=0.002*radius; pan[0]-=dx*s; pan[1]+=dy*s;
  } else { az-=dx*0.4; el+=dy*0.4; el=Math.max(-89,Math.min(89,el)); }
  lx=e.clientX; ly=e.clientY; refresh();};
img.onwheel=e=>{e.preventDefault();
  radius=Math.max(0.3,Math.min(5,radius*(1+e.deltaY*0.001))); refresh();};
document.getElementById('fovy').oninput=refresh;
document.getElementById('scale').oninput=refresh;
document.getElementById('mode').oninput=refresh;
refresh();
</script></body></html>"""


class ViewerState:
    """[N, 14] Gaussians on ``device``, rendered at ``size``² a frame."""

    def __init__(self, gaussians: np.ndarray, size: int = 512,
                 znear: float = 0.5, zfar: float = 2.5,
                 device: str = "cuda"):
        self.dev = resolve_device(device)
        self.size = size
        self.znear, self.zfar = znear, zfar
        self.gaussians = torch.as_tensor(np.asarray(gaussians, np.float32),
                                         device=self.dev)[None]
        # One frame at a time: the server's threads share the card.
        self._lock = threading.Lock()

    def frame(self, el, az, radius, fovy, scale, mode,
              panx=0.0, pany=0.0) -> np.ndarray:
        """One frame [S, S, 3] float in [0, 1]: ``render_views`` of the
        orbit camera, as the image, the alpha, or the alpha-normalised
        depth mapped to [0, 1] over [znear, zfar]."""
        # Pan shifts the orbit target in the camera's screen plane
        # (world-unit offsets along the camera right/up axes), matching
        # the reference GUI's middle-drag pan (ref: gui.py:219-243).
        target = np.zeros(3, np.float32)
        if panx or pany:
            base = camera.orbit_camera(el, az, radius)
            target = base[:3, 0] * panx + base[:3, 1] * pany
        pose = camera.orbit_camera(el, az, radius, target=target)
        cams = camera.build_camera_inputs(pose[None], fovy, self.znear,
                                          self.zfar)
        tan = float(np.tan(0.5 * np.deg2rad(fovy)))
        with self._lock, torch.inference_mode():
            out = render_views(
                self.gaussians,
                torch.as_tensor(cams["cam_view"], device=self.dev)[None],
                self.size, tan, scale_modifier=float(scale),
                dup=32)  # quality over speed off the training path
            a = out["alpha"][0, 0, :, :, 0].cpu().numpy()
            if mode == "alpha":
                return np.repeat(a[..., None], 3, axis=-1)
            if mode != "depth":
                return out["image"][0, 0].cpu().numpy()
            d = out["depth"][0, 0, :, :, 0].cpu().numpy()
        d = np.where(a > 1e-3, d / np.maximum(a, 1e-6), self.zfar)
        d = 1.0 - np.clip((d - self.znear) / (self.zfar - self.znear), 0, 1)
        return np.repeat(d[..., None], 3, axis=-1)


def encode_frame(img: np.ndarray) -> Tuple[bytes, str]:
    """A frame [S, S, 3] in [0, 1] as (bytes, content type): JPEG through
    OpenCV where ``cv2`` imports (lgm_tpu's encoding), else PNG through
    ``io/png.py``. Both quantise as ``(clip(x, 0, 1) * 255)`` truncated."""
    q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        return png.encode(q), "image/png"
    ok, buf = cv2.imencode(".jpg", q[..., ::-1])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes(), "image/jpeg"


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                body = _PAGE.replace("__SIZE__", str(state.size)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/render":
                q = dict(urllib.parse.parse_qsl(url.query))
                t0 = time.perf_counter()
                img = state.frame(
                    float(q.get("el", 0)), float(q.get("az", 0)),
                    float(q.get("radius", 1.5)),
                    float(q.get("fovy", 49.1)),
                    float(q.get("scale", 1.0)), q.get("mode", "image"),
                    panx=float(q.get("panx", 0)),
                    pany=float(q.get("pany", 0)),
                )
                ms = (time.perf_counter() - t0) * 1e3
                body, ctype = encode_frame(img)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("X-Render-Ms", f"{ms:.3f}")
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(404)
            self.end_headers()

    return Handler


def serve(gaussians: np.ndarray, port: int = 7860, size: int = 512,
          device: str = "cuda"):
    state = ViewerState(gaussians, size=size, device=device)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(state))
    print(f"viewer on http://localhost:{port} ({size}x{size})")
    httpd.serve_forever()


def main(argv=None):
    from lgm_tpu_torch.io.ply import load_ply

    parser = argparse.ArgumentParser(description="gaussian splat viewer")
    parser.add_argument("ply")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--device", type=str, default="cuda")
    ns = parser.parse_args(argv)
    serve(load_ply(ns.ply), port=ns.port, size=ns.size, device=ns.device)


if __name__ == "__main__":
    main()
