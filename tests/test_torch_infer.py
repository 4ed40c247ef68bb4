"""The inference slice end to end at the nano preset on the CPU: the port's
forward and orbit vs lgm_tpu's on the same weights and views, and the
port's process() writing a .ply that round-trips."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu import infer as jinfer
from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.io.ply import load_ply as jax_load_ply
from lgm_tpu.models.lgm import LGM as JaxLGM
from lgm_tpu_torch import infer
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.io.ply import load_ply, save_ply
from lgm_tpu_torch.weights import flax_params_to_state_dict, \
    load_state_dict_into
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def nano():
    """Random-init JAX nano LGM (f32), the same weights in the port, four
    seeded views, and the JAX forward's Gaussians."""
    jopt = jax_get_config("nano").replace(unet_remat=False)
    jmodel = JaxLGM(jopt, dtype=jnp.float32)
    x = jnp.zeros((1, 4, jopt.input_size, jopt.input_size, 9), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), x)["params"]
    mv = np.random.default_rng(5).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    g_jax = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(jinfer.build_input(mv, jopt))))
    opt = get_config("nano").replace(mixed_precision="fp32")
    model = infer.load_model(opt, device="cpu")
    load_state_dict_into(model, flax_params_to_state_dict(params))
    return opt, jopt, model, mv, g_jax


def test_forward_matches_jax(nano):
    opt, jopt, model, mv, g_jax = nano
    np.testing.assert_array_equal(infer.build_input(mv, opt),
                                  jinfer.build_input(mv, jopt))
    g = infer.forward_gaussians(model, mv)
    assert g.shape == g_jax.shape == (1, 4 * 16 * 16, 14)
    assert np.abs(g - g_jax).max() <= 1e-4


def test_orbit_frames_match_jax(nano, tmp_path):
    """Port: flatsort + K2's plain version; lgm_tpu on CPU: its exact
    oracle. One 32x32 tile holds all 1024 splats (no truncation), so the
    frames differ only by the 1e-4 early-out and f32 order: <= 2/255."""
    opt, jopt, _, _, g_jax = nano
    ours = infer.render_orbit_video(g_jax[0], opt, n_frames=8, chunk=4,
                                    device="cpu")
    ref = jinfer.render_orbit_video(g_jax[0], jopt, str(tmp_path / "o.mp4"),
                                    n_frames=8, fps=4, chunk=4, n_devices=1)
    assert ours.shape == ref.shape == (8, 32, 32, 3)
    assert ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2


@pytest.mark.parametrize("n_devices,chunk", [(2, 4), (3, 5)])
def test_orbit_split_over_devices_is_the_one_device_video(nano, n_devices,
                                                          chunk):
    """Each chunk's frames split over ``n_devices`` devices (on the CPU,
    the one device n times, each share in its own host thread, as each
    card renders its own) give the one-device video byte for byte: every
    frame is rendered alone, whatever else shares its call. 3 devices and
    chunk 5: the chunk is cut to 3, and the last chunk of 8 frames holds
    2."""
    opt, _, _, _, g_jax = nano
    one = infer.render_orbit_video(g_jax[0], opt, n_frames=8, chunk=4,
                                   device="cpu", n_devices=1)
    split = infer.render_orbit_video(g_jax[0], opt, n_frames=8, chunk=chunk,
                                     device="cpu", n_devices=n_devices)
    assert split.dtype == np.uint8 and split.shape == one.shape
    assert np.array_equal(split, one)


@pytest.mark.parametrize("n_frames,chunk,fancy,n_devices", [
    (180, 30, False, 1), (180, 30, False, 4), (180, 30, False, 8),
    (180, 30, False, 7), (8, 30, False, 16), (5, 2, False, 4),
    (180, 30, True, 8), (12, 1, False, 3)])
def test_orbit_split_rule_is_lgm_tpus(monkeypatch, tmp_path, n_frames, chunk,
                                      fancy, n_devices):
    """The devices and chunk of an orbit render are lgm_tpu's: read off
    the device count its renderer is built for and the frames each call
    gets (its chunk renderer and video writer stubbed)."""
    seen = {}

    def fake_fn(size, tan, n):
        seen["n"] = n

        def render(g, views, sm):
            seen.setdefault("chunks", []).append(views.shape[1])
            return np.zeros((1, views.shape[1], 2, 2, 3), np.uint8)
        return render

    monkeypatch.setattr(jinfer, "_orbit_render_fn", fake_fn)
    monkeypatch.setattr(jinfer, "_write_video", lambda *a: None)
    jopt = jax_get_config("nano")
    jinfer.render_orbit_video(np.zeros((4, 14), np.float32), jopt,
                              str(tmp_path / "o.mp4"), n_frames=n_frames,
                              chunk=chunk, fancy=fancy, n_devices=n_devices)
    n, ours_chunk = infer.orbit_split(n_frames, chunk, fancy, n_devices,
                                      torch.device("cpu"))
    assert n == seen["n"]
    if fancy:  # one frame a call on both sides
        assert set(seen["chunks"]) == {1}
    else:
        assert ours_chunk == seen["chunks"][0]


def test_orbit_devices_default(monkeypatch):
    """By default every CUDA card (four here, so a chunk of 30 becomes
    28), one on the CPU; ``fancy`` one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert infer.orbit_split(180, 30, False, None, cpu) == (1, 30)
    assert infer.orbit_split(180, 30, False, None, cuda) == (4, 28)
    assert infer.orbit_split(180, 30, True, None, cuda) == (1, 30)


def test_process_writes_ply_and_video(nano, tmp_path):
    opt, _, model, mv, g_jax = nano
    out = infer.process(opt, mv, str(tmp_path / "obj"), device="cpu",
                        model=model)
    assert np.abs(out["gaussians"] - g_jax).max() <= 1e-4
    assert out["frames"].shape == (180, 32, 32, 3)
    assert os.path.getsize(out["video"]) > 0
    g = out["gaussians"][0]
    kept = g[g[:, 3] >= 0.005]
    back = load_ply(out["ply"])
    assert back.shape == kept.shape
    # Stored pre-activation (logit, log, SH DC) and re-activated on load.
    np.testing.assert_allclose(back, kept, atol=1e-4)
    np.testing.assert_array_equal(back, jax_load_ply(out["ply"]))


def test_main_cli_runs_on_cpu(tmp_path):
    """The CLI path: four image files -> .ply + video in the workspace."""
    import cv2

    rng = np.random.default_rng(2)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"v{i}.png")
        cv2.imwrite(p, rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
        paths.append(p)
    ws = tmp_path / "ws"
    infer.main(["nano", "--mv-images", *paths, "--workspace", str(ws),
                "--device", "cpu"])
    assert (ws / "v0.ply").exists()
    assert any(f.name.startswith("v0.") and f.suffix in (".mp4", ".npy")
               for f in ws.iterdir())


def test_cli_reads_pngs_without_cv2(tmp_path):
    """The card host has no cv2: in a subprocess where ``import cv2``
    fails, ``--mv-images`` reads PNGs the port wrote (RGBA with
    transparency, RGB, gray + alpha, gray) through io/png.py, and its
    Gaussians (the .ply) equal the array path's, the same model's forward
    on the views loaded here. Those views are cv2's (imread, composite, INTER_AREA
    resize) within 1.2e-7: utils/resize.py sums the area weights in
    float64."""
    import subprocess
    import sys

    import cv2

    from lgm_tpu_torch.io import png

    rng = np.random.default_rng(4)
    paths = []
    for i, channels in enumerate((4, 3, 2, 1)):
        img = rng.integers(0, 256, (40, 40, channels), dtype=np.uint8)
        paths.append(str(tmp_path / f"v{i}.png"))
        png.write(paths[-1], img[..., 0] if channels == 1 else img)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['cv2'] = None\n"
            "from lgm_tpu_torch import infer\n"
            "infer.main(sys.argv[1:])\n")
    ws = tmp_path / "ws"
    proc = subprocess.run(
        [sys.executable, "-c", code, "nano", "--mv-images", *paths,
         "--workspace", str(ws), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (ws / "v0.frames.npy").exists()   # no cv2: no mp4 writer
    opt = get_config("nano")
    mv = np.stack([infer._load_rgba(p, opt.input_size) for p in paths])
    gaussians = infer.forward_gaussians(infer.load_model(opt, device="cpu"),
                                        mv)
    save_ply(gaussians, str(tmp_path / "array.ply"))
    np.testing.assert_array_equal(load_ply(str(ws / "v0.ply")),
                                  load_ply(str(tmp_path / "array.ply")))
    for p, view in zip(paths, mv):
        img = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32) / 255
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        if img.shape[-1] == 4:
            a = img[..., 3:4]
            img = img[..., [2, 1, 0]] * a + (1 - a)
        else:
            img = img[..., [2, 1, 0]]
        want = cv2.resize(img, (opt.input_size,) * 2,
                          interpolation=cv2.INTER_AREA)
        np.testing.assert_allclose(view, want, rtol=0, atol=1.2e-7)


def _jpegs(tmp_path, size=40):
    """Four JPEG views written by cv2: 4:2:0, 4:4:4, 4:2:2 and gray."""
    import cv2

    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:size, 0:size]
    paths = []
    for i, sampling in enumerate((0x221111, 0x111111, 0x211111, None)):
        img = np.stack([(x * 6 + 40 * i) % 256, (y * 5) % 256,
                        (x * y) % 256], -1).astype(np.uint8)
        img[10:14] = rng.integers(0, 256, (4, size, 3))
        params = [cv2.IMWRITE_JPEG_QUALITY, 85]
        if sampling is None:
            img = img[..., 1]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
        paths.append(str(tmp_path / f"v{i}.jpg"))
        assert cv2.imwrite(paths[-1], img, params)
    return paths


def test_cli_reads_jpegs_without_cv2(tmp_path):
    """``--mv-images`` on JPEG files in a subprocess where ``import cv2``
    fails: the port's decoder (io/jpeg.py) reads them, the .ply equals
    the array path's (the same model's forward on the views loaded here),
    and those views are lgm_tpu's ``_load_rgba`` (cv2.imread, INTER_AREA)
    within the PNG test's 1.2e-7."""
    import subprocess
    import sys

    paths = _jpegs(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['cv2'] = None\n"
            "from lgm_tpu_torch import infer\n"
            "infer.main(sys.argv[1:])\n")
    ws = tmp_path / "ws"
    proc = subprocess.run(
        [sys.executable, "-c", code, "nano", "--mv-images", *paths,
         "--workspace", str(ws), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    opt = get_config("nano")
    mv = np.stack([infer._load_rgba(p, opt.input_size) for p in paths])
    gaussians = infer.forward_gaussians(infer.load_model(opt, device="cpu"),
                                        mv)
    save_ply(gaussians, str(tmp_path / "array.ply"))
    np.testing.assert_array_equal(load_ply(str(ws / "v0.ply")),
                                  load_ply(str(tmp_path / "array.ply")))
    for p, view in zip(paths, mv):
        np.testing.assert_allclose(view, jinfer._load_rgba(p, opt.input_size),
                                   rtol=0, atol=1.2e-7)


class _StubPipe:
    """An image-conditioned pipeline's stand-in: records its image and
    returns fixed views."""

    def __init__(self, mv):
        self.mv, self.images = mv, []

    def __call__(self, image, **kw):
        self.images.append(image)
        return self.mv


def test_cli_image_reads_a_jpeg_without_cv2(tmp_path, monkeypatch):
    """``--image x.jpg`` with ``cv2`` blocked: the image handed to the
    pipeline is lgm_tpu's (``cv2.imread(IMREAD_UNCHANGED) / 255``, BGR ->
    RGB) bit for bit, and the .ply is the array path's on the same
    pipeline views; a corrupt JPEG raises ``ImageError`` as a corrupt PNG
    raises ``PngError``."""
    import sys

    import cv2

    from lgm_tpu_torch.diffusion import pipeline
    from lgm_tpu_torch.io import ImageError

    path = _jpegs(tmp_path, 64)[0]
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 255
    opt = get_config("nano")
    views = np.random.default_rng(8).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32)
    stub = _StubPipe(views)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(pipeline.MVDreamPipeline, "from_pretrained",
                        classmethod(lambda cls, *a, **k: stub))
    ws = tmp_path / "ws"
    infer.main(["nano", "--image", path, "--diffusion-ckpt", "unused",
                "--workspace", str(ws), "--device", "cpu"])
    (image,) = stub.images
    np.testing.assert_array_equal(image, want[..., [2, 1, 0]])
    mv = infer.image_to_views(_StubPipe(views), want, opt)
    gaussians = infer.forward_gaussians(infer.load_model(opt, device="cpu"),
                                        mv)
    save_ply(gaussians, str(tmp_path / "array.ply"))
    np.testing.assert_array_equal(load_ply(str(ws / "v0.ply")),
                                  load_ply(str(tmp_path / "array.ply")))
    with open(path, "rb") as fh:
        data = fh.read()
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(data[:len(data) // 2])
    with pytest.raises(ImageError, match="bad.jpg"):
        infer._load_rgba(str(bad), opt.input_size)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    opt = get_config("nano")
    mv = np.zeros((4, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.process(opt, mv, "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.render_orbit_video(np.zeros((8, 14), np.float32), opt)


def test_load_model_reads_a_training_checkpoint(tmp_path):
    """A ckpt_N that train.save_checkpoint wrote (LGMWithLoss's state dict
    under "params": lgm.* and lpips_loss.* keys) loads through
    infer.load_model, as lgm_tpu's inference reads its trainer's
    checkpoints, and gives the trained model's Gaussians bit for bit."""
    from lgm_tpu_torch import train
    from lgm_tpu_torch.data.synthetic import make_batch

    opt = get_config("nano")
    state = train.create_state(opt, "cpu")
    batch = make_batch(np.random.default_rng(1), opt, batch_size=2,
                       n_gaussians=32, device="cpu")
    data = {k: v for k, v in batch.items() if k != "scenes"}
    for _ in range(2):
        train.train_step(state, data, torch.ones(3))
    path = train.save_checkpoint(str(tmp_path), state, step=2)
    assert any(k.startswith("lpips_loss.") for k in torch.load(
        path, weights_only=True)["params"]) == (state.model.lpips_loss
                                                is not None)
    model = infer.load_model(opt, path, "cpu")
    mv = np.random.default_rng(5).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    ours = infer.forward_gaussians(model, mv)
    trained = infer.forward_gaussians(state.model.lgm.eval(), mv)
    np.testing.assert_array_equal(ours, trained)
    fresh = infer.forward_gaussians(infer.load_model(opt, device="cpu"), mv)
    assert not np.array_equal(ours, fresh)


@pytest.mark.parametrize("form", ["state_dict.pt", "model.pt",
                                  "state_dict.safetensors"])
def test_load_model_reads_reference_state_dicts(tmp_path, form):
    """The reference forms still load: a plain state dict, one under a
    "model" key (with an LPIPS key, which is dropped), a .safetensors."""
    opt = get_config("nano")
    src = infer.load_model(opt, device="cpu")
    rng = np.random.default_rng(3)
    sd = {k: v + torch.as_tensor(rng.normal(0, 0.01, tuple(v.shape)),
                                 dtype=v.dtype)
          for k, v in src.state_dict().items()}
    path = str(tmp_path / form)
    if form == "state_dict.safetensors":
        from safetensors.torch import save_file

        save_file(sd, path)
    elif form == "model.pt":
        torch.save({"model": {**sd, "lpips.net.0.weight": torch.zeros(1)}},
                   path)
    else:
        torch.save(sd, path)
    model = infer.load_model(opt, path, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
