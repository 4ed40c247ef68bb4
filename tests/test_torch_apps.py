"""The serving surfaces of the port (lgm_tpu_torch/apps/) on the CPU: the
splat viewer's HTTP handler (page, frames with X-Render-Ms, 404), its
frames against lgm_tpu's ViewerState on the same Gaussians, the frame
encodings (JPEG through cv2 where it imports, else PNG); the app's
multipart upload of four PNG views, and of four JPEG views, at nano (the
.ply it serves is the .ply of the port's forward on the same decoded
views; the JPEG views are lgm_tpu's handler arithmetic on cv2.imdecode),
its error text for a part that is neither a readable PNG nor JPEG, and
run_image from a tiny ImageDream directory
against lgm_tpu's AppState.run_image with the weights carried across.

Frame tolerance (trap C2): lgm_tpu renders through its exact oracle on
the CPU, the port through flatsort with dup 32; the scene (256 splats at
64², 4 tiles) truncates nothing there, so the two differ only by the
1e-4 early-out and the f32 order: 2e-3.
"""

import dataclasses
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import jax
import torch

from lgm_tpu.apps import app as japp
from lgm_tpu.apps import viewer as jviewer
from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.diffusion import pipeline as jpipe
from lgm_tpu.tools.convert_diffusion import (convert_component,
                                             unet_torch_to_flax,
                                             vae_torch_to_flax)
from lgm_tpu_torch import infer
from lgm_tpu_torch.apps import app, viewer
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.diffusion import pipeline as tpipe
from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer
from lgm_tpu_torch.io import png
from lgm_tpu_torch.io.ply import save_ply
from lgm_tpu_torch.weights import diffusion_params_to_state_dicts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FRAME_ATOL = 2e-3
FIX = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "fixtures", "clip_tokenizer")


def _scene():
    rng = np.random.default_rng(2)
    g = np.zeros((256, 14), np.float32)
    g[:, 0:3] = rng.normal(0, 0.3, (256, 3))
    g[:, 3] = 0.9
    g[:, 4:7] = 0.05
    g[:, 7] = 1.0
    g[:, 11:14] = rng.uniform(0, 1, (256, 3))
    return g


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def viewer_server():
    state = viewer.ViewerState(_scene(), size=64, device="cpu")
    httpd, url = _serve(viewer._make_handler(state))
    yield state, url
    httpd.shutdown()


def test_viewer_serves_page_frames_and_404(viewer_server):
    state, url = viewer_server
    with urllib.request.urlopen(url + "/") as r:
        body = r.read().decode()
    assert r.status == 200
    assert "lgm_tpu viewer" in body and "X-Render-Ms" in body
    q = "/render?el=10&az=30&radius=1.5&fovy=49.1&scale=1"
    frames = {}
    for mode in ("image", "alpha", "depth"):
        with urllib.request.urlopen(url + q + "&mode=" + mode) as r:
            frames[mode] = (r.headers["Content-Type"], r.read())
            assert float(r.headers["X-Render-Ms"]) > 0
    ctype, data = frames["image"]
    assert ctype in ("image/jpeg", "image/png")
    with urllib.request.urlopen(url + "/render?el=-30&az=200&radius=2.0") \
            as r:
        assert r.read() != data
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/nope")
    assert err.value.code == 404


@pytest.mark.parametrize("mode", ["image", "alpha", "depth"])
def test_viewer_frames_match_lgm_tpu(mode):
    ours = viewer.ViewerState(_scene(), size=64, device="cpu")
    ref = jviewer.ViewerState(_scene(), size=64)
    for args in ((10.0, 30.0, 1.5, 49.1, 1.0), (-20.0, 200.0, 2.0, 60.0,
                                                 0.7)):
        for pan in ((0.0, 0.0), (0.1, -0.05)):
            a = ours.frame(*args, mode, panx=pan[0], pany=pan[1])
            b = ref.frame(*args, mode, panx=pan[0], pany=pan[1])
            assert a.shape == b.shape == (64, 64, 3)
            assert np.abs(a - np.asarray(b)).max() <= FRAME_ATOL


def test_frame_encodings(monkeypatch):
    """PNG where cv2 does not import: the quantised frame bit for bit. JPEG
    through cv2 where it does, as lgm_tpu's viewer sends it."""
    state = viewer.ViewerState(_scene(), size=64, device="cpu")
    img = state.frame(10.0, 30.0, 1.5, 49.1, 1.0, "image")
    q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    data, ctype = viewer.encode_frame(img)
    assert ctype == "image/png"
    np.testing.assert_array_equal(png.decode_rgba(data)[0][..., :3], q)
    monkeypatch.undo()
    cv2 = pytest.importorskip("cv2")
    data, ctype = viewer.encode_frame(img)
    assert ctype == "image/jpeg" and data[:2] == b"\xff\xd8"
    ok, ref = cv2.imencode(".jpg", q[..., ::-1])
    assert ok and data == ref.tobytes()


def _multipart(parts, boundary="xXbOuNdArYxX"):
    body = b"".join(
        f'--{boundary}\r\nContent-Disposition: form-data; '
        f'name="{name}"; filename="{name}.png"\r\n'
        f"Content-Type: image/png\r\n\r\n".encode() + data + b"\r\n"
        for name, data in parts) + f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


@pytest.fixture(scope="module")
def app_server():
    opt = get_config("nano").replace(num_input_views=4,
                                     mixed_precision="fp32")
    state = app.AppState(opt, resume=None, device="cpu")
    httpd, url = _serve(app._make_stdlib_handler(state))
    yield state, url
    httpd.shutdown()


def _views(seed, size=48):
    rng = np.random.default_rng(seed)
    views = []
    for i in range(4):
        rgba = rng.integers(0, 256, (size, size, 4)).astype(np.uint8)
        if i == 0:
            rgba = rgba[..., :3]     # one view without alpha
        views.append(rgba)
    return views


def test_app_upload_writes_the_forward_of_the_decoded_views(app_server):
    state, url = app_server
    with urllib.request.urlopen(url + "/") as r:
        assert r.status == 200 and "form" in r.read().decode()
    views = _views(4)
    body, headers = _multipart([(f"v{i}", png.encode(v))
                                for i, v in enumerate(views)])
    req = urllib.request.Request(url + "/mv", data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.read().decode()
    assert "done" in out and "upload.ply" in out
    with urllib.request.urlopen(url + "/files/") as r:
        listing = r.read().decode()
    assert "upload.ply" in listing
    assert "upload.mp4" in listing or "upload.frames.npy" in listing
    with urllib.request.urlopen(url + "/files/upload.ply") as r:
        served = r.read()

    # The same views decoded as the handler does (cv2.imdecode's BGR(A),
    # over white, cv2.resize to the input size), through the same model.
    s = state.opt.input_size
    mv = np.stack([app.decode_view(png.encode(v), "v", s) for v in views])
    rgb = views[1][..., :3].astype(np.float32) / 255
    a = views[1][..., 3:4].astype(np.float32) / 255
    from lgm_tpu_torch.utils.resize import resize
    np.testing.assert_array_equal(mv[1], resize(rgb * a + (1 - a), (s, s),
                                                "linear"))
    expected = str(state.workdir) + "/expected.ply"
    save_ply(infer.forward_gaussians(state.model, mv), expected)
    assert served == open(expected, "rb").read()


def test_app_upload_names_a_part_that_is_not_png(app_server):
    _, url = app_server
    parts = [(f"v{i}", png.encode(v)) for i, v in enumerate(_views(5))]
    parts[2] = ("v2", b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    body, headers = _multipart(parts)
    req = urllib.request.Request(url + "/mv", data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.read().decode()
        assert r.headers["Content-Type"] == "text/plain"
    # A corrupt JPEG is reported, naming the part, as a corrupt PNG is.
    assert "error: v2.png: corrupt data" in out
    body, headers = _multipart(parts[:3])
    req = urllib.request.Request(url + "/mv", data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as r:
        assert "v2.png: corrupt data" in r.read().decode()
    parts[2] = ("v2", b"GIF89a" + b"\x00" * 64)
    body, headers = _multipart(parts)
    req = urllib.request.Request(url + "/mv", data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as r:
        assert "v2.png is an unknown format" in r.read().decode()


def test_app_upload_of_jpegs_matches_lgm_tpu_handler(app_server):
    """Four JPEG parts (4:2:0, 4:4:4, 4:2:2, 4:1:1): each view is lgm_tpu's
    handler arithmetic on ``cv2.imdecode(IMREAD_UNCHANGED)`` (/ 255, BGR ->
    RGB, ``cv2.resize`` linear), and the served .ply is the forward's on
    those views."""
    import cv2

    state, url = app_server
    s = state.opt.input_size
    datas = []
    for i, sampling in enumerate((0x221111, 0x111111, 0x211111, 0x411111)):
        ok, buf = cv2.imencode(".jpg", _views(6)[1][..., :3], [
            cv2.IMWRITE_JPEG_QUALITY, 70 + 5 * i,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        datas.append(buf.tobytes())
    body, headers = _multipart([(f"v{i}", d) for i, d in enumerate(datas)])
    req = urllib.request.Request(url + "/mv", data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as r:
        assert "done" in r.read().decode()
    with urllib.request.urlopen(url + "/files/upload.ply") as r:
        served = r.read()
    mv = np.stack([app.decode_view(d, f"v{i}", s)
                   for i, d in enumerate(datas)])
    for view, data in zip(mv, datas):
        arr = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        img = arr.astype(np.float32)[..., [2, 1, 0]] / 255
        np.testing.assert_allclose(view, cv2.resize(img, (s, s)), rtol=0,
                                   atol=1.2e-7)
    expected = str(state.workdir) + "/expected_jpeg.ply"
    save_ply(infer.forward_gaussians(state.model, mv), expected)
    assert served == open(expected, "rb").read()


def test_run_image_matches_lgm_tpu(tmp_path, monkeypatch):
    """AppState.run_image from a tiny ImageDream directory (the
    pipeline's diffusers layout, as tests/test_torch_diffusion.py writes
    it) against lgm_tpu's AppState.run_image with the same weights: the
    four views each hands run_mv, at the pipeline's image tolerance
    (tests/test_golden_pipeline.py's 2e-3)."""
    cfg = dataclasses.replace(tpipe.CONFIGS["tiny-test-ip"],
                              channel_mult=(1, 2, 2),
                              attention_resolutions=(4,),
                              vae_channels=(32, 32, 32, 32),
                              compute_dtype="float32")
    torch.manual_seed(0)
    tp = tpipe.MVDreamPipeline(cfg, device="cpu", tokenizer=CLIPTokenizer(
        FIX, cfg.max_tokens))
    # A zero stem bias keeps the uncond branch's all-zero ip frame exactly
    # 0 into the first GroupNorm (tests/test_torch_diffusion.py::pipes).
    with torch.no_grad():
        tp.unet.input_blocks[0][0].bias.zero_()
    jp = jpipe.MVDreamPipeline(
        jpipe.PipelineConfig(**dataclasses.asdict(cfg)), params={})
    port_sd = {n: {k: v.numpy() for k, v in m.state_dict().items()}
               for n, m in (("unet", tp.unet), ("vae", tp.vae))}
    jp.params = {
        "unet": convert_component(port_sd["unet"], unet_torch_to_flax),
        "vae": convert_component(port_sd["vae"], vae_torch_to_flax),
        "text_encoder": jp._text_model.init_weights(
            jax.random.PRNGKey(1), (1, cfg.max_tokens)),
        "image_encoder": jp._vision_model.init_weights(
            jax.random.PRNGKey(2), (1, cfg.image_size, cfg.image_size, 3)),
    }
    tp.load_state_dicts(diffusion_params_to_state_dicts(
        jax.tree_util.tree_map(np.asarray, {
            k: jp.params[k] for k in ("text_encoder", "image_encoder")})))
    tp.save_pretrained(str(tmp_path / "dream"))
    # lgm_tpu reads the directory's CLIP BPE vocabulary (transformers).
    jp.tokenizer = jpipe.MVDreamPipeline._maybe_tokenizer(
        str(tmp_path / "dream"), jp.cfg)

    # The directory is read as it is; the pipeline computes in f32, as the
    # twin tests run (a directory's configs give no compute dtype, and
    # from_pretrained's default is the published bf16).
    read = tpipe.MVDreamPipeline.config_from_dir
    monkeypatch.setattr(tpipe.MVDreamPipeline, "config_from_dir",
                        staticmethod(lambda path: dataclasses.replace(
                            read(path), compute_dtype="float32")))
    opt = get_config("nano").replace(num_input_views=4,
                                     mixed_precision="fp32")
    ours = app.AppState(opt, None, str(tmp_path / "dream"), device="cpu")
    assert ours.pipe.cfg == dataclasses.replace(cfg, allow_hash_tokenizer=False)
    ref = japp.AppState(jax_get_config("nano").replace(num_input_views=4),
                        None, None)
    # The same initial latents into both (each framework draws its own
    # from the seed): [5 frames, 32², 4] at the pipeline's 256².
    lat0 = np.random.default_rng(8).normal(0, 1, (5, 32, 32, 4)).astype(
        np.float32)
    loaded = ours.pipe
    ours.pipe = lambda **kw: loaded(latents=lat0, **kw)
    ref.pipe = lambda **kw: jp(latents=lat0, **kw)
    got = {}
    monkeypatch.setattr(ours, "run_mv", lambda mv, name: got.setdefault(
        "ours", mv))
    monkeypatch.setattr(ref, "run_mv", lambda mv, name: got.setdefault(
        "ref", mv))
    rng = np.random.default_rng(7)
    image = np.zeros((80, 64, 4), np.float32)
    image[16:70, 10:50] = rng.uniform(0, 1, (54, 40, 4))
    image[16:70, 10:50, 3] = 1.0
    kw = dict(prompt="a red chair", elevation=10.0, steps=2, seed=3)
    ours.run_image(image, **kw)
    ref.run_image(image, **kw)
    assert got["ours"].shape == got["ref"].shape == (4, 32, 32, 3)
    assert np.abs(got["ours"] - np.asarray(got["ref"])).max() <= 2e-3
