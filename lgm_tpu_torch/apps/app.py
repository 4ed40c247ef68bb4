"""Serving app: four views, an image or a prompt -> 3D (ply + orbit).

Port of ``lgm_tpu/apps/app.py``, the redesign of the reference gradio app
(ref: app.py:27-249), over the same ``process`` pipeline. ``AppState``
loads LGM once and hands it to every ``infer.process`` call (kernels K1
and K2 on the card: K1 16 and K2 180 a request at ``big``), and the
diffusion front-end once where a diffusers-layout directory is given.

The front end served is the stdlib HTTP one: an upload form for four
prepared PNG or JPEG views (decoded by ``io/image.py`` with
``cv2.imdecode``'s pixels, composited over white, resized as
``cv2.resize`` does); the response links the ``.ply`` and the orbit
(``.mp4`` where ``cv2`` imports, else ``<stem>.frames.npy``). lgm_tpu's gradio UI is not ported
yet: where ``gradio`` imports, ``main`` says so and serves the form.
``rembg`` is absent on the hosts the port runs on, so ``_carve`` keeps
lgm_tpu's fallback, the image's own alpha.

Serving is single-model, synchronous, one request at a time, as the
reference's queue() (app.py:186).

Run: python -m lgm_tpu_torch.apps.app big [--resume ckpt]
         [--diffusion-ckpt DIR] [--port 7861] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from lgm_tpu_torch import infer
from lgm_tpu_torch.config import CONFIGS, Options
from lgm_tpu_torch.io import ImageError
from lgm_tpu_torch.io import image as imageio
from lgm_tpu_torch.utils.image import mv_grid_2x2, recenter, rgba_to_rgb_white
from lgm_tpu_torch.utils.resize import resize


def _carve(image: np.ndarray) -> Optional[np.ndarray]:
    """[H, W, 3|4] float RGB(A) in [0,1] -> [H, W, 4] RGBA with the
    foreground carved out: rembg when importable, else the image's own
    alpha; None when neither provides a mask."""
    try:
        import rembg
    except ImportError:
        if image.shape[-1] == 4:
            return image.astype(np.float32)
        return None
    out = rembg.remove((np.clip(image[..., :3], 0, 1) * 255).astype(np.uint8))
    return np.asarray(out, np.float32) / 255.0


class AppState:
    """The served models on ``device``: LGM (``resume`` or seeded weights,
    as ``infer.load_model``) and, with ``diffusion_ckpt``, the diffusion
    front-end."""

    def __init__(self, opt: Options, resume: Optional[str],
                 diffusion_ckpt: Optional[str] = None, device: str = "cuda"):
        self.opt = opt
        self.resume = resume
        self.device = device
        self.model = infer.load_model(opt, resume, device)
        self.workdir = tempfile.mkdtemp(prefix="lgm_app_")
        self.pipe = None
        if diffusion_ckpt:
            from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline

            self.pipe = MVDreamPipeline.from_pretrained(diffusion_ckpt,
                                                        device=device)
        self._lock = threading.Lock()

    def run_mv(self, mv_images: np.ndarray, name: str):
        """mv_images [4, H, W, 3] in [0,1] -> (grid, ply_path, video_path).
        Grid is the reference's 2x2 preview layout (ref: app.py:109-112)."""
        stem = os.path.join(self.workdir, name)
        with self._lock:
            res = infer.process(self.opt, mv_images, stem,
                                device=self.device, model=self.model)
        return mv_grid_2x2(mv_images), res["ply"], res["video"]

    def _views(self, mv: np.ndarray) -> np.ndarray:
        s = self.opt.input_size
        return np.stack([resize(m, (s, s), "linear") for m in mv])

    def run_image(self, image: np.ndarray, prompt: str = "",
                  negative_prompt: str = "", elevation: float = 0.0,
                  steps: int = 30, guidance: float = 5.0, seed: int = 0,
                  name: str = "out"):
        """One RGB(A) image in [0, 1] -> the diffusion front-end's views
        ``[1, 2, 3, 0]`` -> ``run_mv``."""
        assert self.pipe is not None, (
            "diffusion front-end not loaded; pass --diffusion-ckpt or "
            "use the four-view input"
        )
        # rembg carve + recenter like the reference image path
        # (ref: app.py:100-106); fall back to the image's own alpha.
        rgba = _carve(image)
        if rgba is not None:
            rgba = recenter(rgba, rgba[..., 3] > 0, border_ratio=0.2)
            image = rgba_to_rgb_white(rgba)
        mv = self.pipe(prompt=prompt, image=image,
                       negative_prompt=negative_prompt,
                       elevation=elevation,
                       num_inference_steps=steps, guidance_scale=guidance,
                       seed=seed)
        mv = mv[[1, 2, 3, 0]]  # reference view order (ref: infer.py:92)
        return self.run_mv(self._views(mv), name)

    def run_text(self, prompt: str, negative_prompt: str = "",
                 elevation: float = 0.0, steps: int = 30,
                 guidance: float = 7.5, seed: int = 0, name: str = "out"):
        assert self.pipe is not None
        mv = self.pipe(prompt=prompt, image=None,
                       negative_prompt=negative_prompt,
                       elevation=elevation,
                       num_inference_steps=steps, guidance_scale=guidance,
                       seed=seed)
        # Per-view bg cleanup on the text path (ref: app.py:89-97):
        # carve each generated view, recenter, composite on white.
        cleaned = []
        for v in mv[:4]:
            rgba = _carve(v)
            if rgba is None:
                cleaned.append(v)
                continue
            rgba = recenter(rgba, rgba[..., 3] > 0, border_ratio=0.2)
            cleaned.append(rgba_to_rgb_white(rgba))
        return self.run_mv(self._views(np.stack(cleaned)), name)


_FORM = """<!doctype html><html><body style="font-family:monospace">
<h2>lgm_tpu</h2>
<form method=post enctype=multipart/form-data action=/mv>
  four PNG or JPEG views (az 0/90/180/270):
  <input type=file name=v0><input type=file name=v1>
  <input type=file name=v2><input type=file name=v3>
  <input type=submit value="reconstruct">
</form>
<p>artifacts appear under <a href=/files/>/files/</a></p>
</body></html>"""


def decode_view(data: bytes, name: str, size: int) -> np.ndarray:
    """An uploaded PNG or JPEG -> [size, size, 3] RGB float over white,
    as lgm_tpu's handler makes it from ``cv2.imdecode(IMREAD_UNCHANGED)``
    (straight alpha composited, then ``cv2.resize``, linear). Raises
    ``ImageError`` naming ``name`` for a part that is neither, or that the
    reader refuses."""
    arr = imageio.decode_cv2(data, name)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    img = arr.astype(np.float32) / 255.0
    if img.shape[-1] == 4:
        a = img[..., 3:4]
        img = img[..., [2, 1, 0]] * a + (1 - a)
    else:
        img = img[..., [2, 1, 0]]
    return resize(img, (size, size), "linear")


def _make_stdlib_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _ok(self, body, ctype="text/html"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body if isinstance(body, bytes)
                             else body.encode())

        def do_GET(self):
            if self.path == "/":
                return self._ok(_FORM)
            if self.path.startswith("/files"):
                rel = self.path[len("/files"):].lstrip("/")
                if not rel:
                    listing = "".join(
                        f'<a href="/files/{f}">{f}</a><br>'
                        for f in sorted(os.listdir(state.workdir))
                    )
                    return self._ok(listing or "empty")
                p = os.path.realpath(os.path.join(state.workdir, rel))
                if p.startswith(os.path.realpath(state.workdir)) \
                        and os.path.exists(p):
                    with open(p, "rb") as f:
                        return self._ok(f.read(),
                                        "application/octet-stream")
            self.send_response(404)
            self.end_headers()

        def do_POST(self):
            import email
            from email import policy

            length = int(self.headers["Content-Length"])
            ctype = self.headers["Content-Type"]
            msg = email.message_from_bytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n"
                + self.rfile.read(length),
                policy=policy.default,
            )
            imgs = []
            for part in msg.iter_parts():
                data = part.get_payload(decode=True)
                if not data:
                    continue
                name = part.get_filename() or part.get_param(
                    "name", header="content-disposition") or "part"
                try:
                    imgs.append(decode_view(data, name,
                                            state.opt.input_size))
                except ImageError as exc:
                    return self._ok(f"error: {exc}", "text/plain")
            if len(imgs) != 4:
                return self._ok("need exactly 4 views", "text/plain")
            _, ply, video = state.run_mv(np.stack(imgs), "upload")
            return self._ok(
                f'done: <a href="/files/{os.path.basename(ply)}">ply</a> '
                f'<a href="/files/{os.path.basename(video)}">video</a>'
            )

    return Handler


def launch_stdlib(state: AppState, port: int):
    httpd = ThreadingHTTPServer(("0.0.0.0", port),
                                _make_stdlib_handler(state))
    print(f"app on http://localhost:{port} (stdlib front end)")
    httpd.serve_forever()


def main(argv=None):
    parser = argparse.ArgumentParser(description="lgm_tpu_torch serving app")
    parser.add_argument("config", nargs="?", default="big",
                        choices=sorted(CONFIGS))
    parser.add_argument("--resume", default=None)
    parser.add_argument("--diffusion-ckpt", default=None)
    parser.add_argument("--port", type=int, default=7861)
    parser.add_argument("--device", type=str, default="cuda")
    ns = parser.parse_args(argv)
    state = AppState(CONFIGS[ns.config], ns.resume, ns.diffusion_ckpt,
                     device=ns.device)
    try:
        import gradio  # noqa: F401
    except ImportError:
        pass
    else:
        print("gradio is installed, but the gradio UI is not ported yet: "
              "serving the stdlib upload form")
    launch_stdlib(state, ns.port)


if __name__ == "__main__":
    main()
