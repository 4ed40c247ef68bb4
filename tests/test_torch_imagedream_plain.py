"""The port's ImageDream path against the plain reference
(``tests/plain_imagedream.py``) at ``tiny-pipe-ip`` in f32 on the CPU: one
seeded state dict loaded into both, then each CLIP tower, the U-Net's ε
(camera, ip features, ip latent), the VAE both ways, the DDIM loop and the
whole of ``infer.image_to_views``; the control (the reference a step below
each stated precision) fails a tolerance; the benchmark's copy of the
reference is the same file.

Tolerances, each the f32 program against the f32 reference (relative
Frobenius gap unless said): the towers and the VAE 1e-5 (the same
products, which another order or thread count may round apart; on one
CPU thread they read 0); the U-Net's ε 1e-4 (a deeper chain of the same;
0); the DDIM loop's latents 1e-4 of their norm (30 guided steps carry
ε's gap on, x5 a step at guidance 5; 5e-7); the views 1e-3 in [0, 1] at
the worst pixel (the loop's gap through the decoder, plus the host
resizes, whose weights OpenCV keeps in f32). The control's gaps read
4e-3 (the CLIP towers in bf16) to 0.19 (ε in fp8)."""

import dataclasses
import filecmp
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lgm_tpu_torch import infer
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.diffusion.pipeline import CONFIGS, MVDreamPipeline
import plain_imagedream as ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = Path(__file__).resolve().parent

CONFIG = "tiny-pipe-ip"
TOL = {"text": 1e-5, "vision": 1e-5, "encode": 1e-5, "decode": 1e-5,
       "eps": 1e-4, "ddim": 1e-4}
VIEW_TOL = 1e-3
SIZE = 32            # the tiny pipeline's image: 16² latents (VAE f = 2)


def gap(a, b) -> float:
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def seeded_weights(cfg: dict, seed: int) -> dict:
    """{component: {name: f32 tensor}}: std 1/sqrt(fan_in) for kernels and
    embeddings, 1 + 0.1 n for norm scales, 0.02 n for the rest."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for comp, shapes in ref.param_shapes(cfg).items():
        norms = set(ref.norm_scales(shapes))
        out[comp] = {}
        for name, shape in shapes.items():
            w = torch.randn(shape, generator=gen)
            if name in norms:
                w = 1.0 + 0.1 * w
            elif len(shape) >= 2:
                w = w * (math.prod(shape) // shape[0]) ** -0.5
            else:
                w = 0.02 * w
            out[comp][name] = w
    return out


class Small:
    """The pipeline at the tiny image size: ``image_to_views`` asks for
    256², which the tiny U-Net would see as 128² latents."""

    def __init__(self, pipe):
        self.pipe = pipe

    def __call__(self, **kw):
        return self.pipe(height=SIZE, width=SIZE, **kw)


@pytest.fixture(scope="module")
def both():
    cfg = dataclasses.asdict(CONFIGS[CONFIG])
    w = seeded_weights(cfg, 3)
    pipe = MVDreamPipeline(CONFIGS[CONFIG], "cpu")
    pipe.load_state_dicts(w)
    return pipe, w, cfg


@pytest.fixture(scope="module")
def image():
    """A 40x48 BGRA image in [0, 1] whose alpha covers a box."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (40, 48, 4)).astype(np.float32)
    img[..., 3] = 0.0
    img[6:30, 9:41, 3] = rng.uniform(0.2, 1.0, (24, 32))
    return img


def test_reference_copies_are_identical_and_plain():
    bench = HERE.parent / "portbench" / "reference" / "imagedream.py"
    assert filecmp.cmp(HERE / "plain_imagedream.py", bench, shallow=False)
    src = (HERE / "plain_imagedream.py").read_text()
    assert "import jax" not in src and "lgm_tpu" not in src
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ref.exact()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_names_and_shapes_are_the_programs(both):
    pipe, w, _ = both
    for comp, module in pipe.modules().items():
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in w[comp].items()}, comp


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_clip_towers(both, image, tower):
    pipe, w, cfg = both
    with torch.inference_mode():
        if tower == "text":
            ids = torch.as_tensor(pipe.tokenizer("a red chair"))
            got = pipe.text_encoder(ids)
            want = ref.text_tower(w["text_encoder"], ids, cfg)
            low = ref.text_tower(w["text_encoder"], ids, cfg, ref.bf16)
        else:
            rgb = image[..., [2, 1, 0]]
            got = pipe.encode_image(rgb)[1]
            px = ref.clip_pixels(torch.as_tensor(rgb), cfg["image_size"])
            want = ref.vision_tower(w["image_encoder"], px, cfg)
            low = ref.vision_tower(w["image_encoder"], px, cfg, ref.bf16)
    assert gap(got, want) <= TOL[tower]
    assert gap(low, want) > 100 * TOL[tower]


@pytest.mark.parametrize("way", ["encode", "decode"])
def test_vae(both, image, way):
    pipe, w, cfg = both
    rgb = image[..., [2, 1, 0]]
    with torch.inference_mode():
        if way == "encode":
            got = pipe.encode_image_latents(rgb, size=SIZE)[1]
            x = ref.vae_pixels(torch.as_tensor(rgb), SIZE)
            want = ref.vae_encode(w["vae"], x, cfg)
            low = ref.vae_encode(w["vae"], x, cfg, ref.fp8)
        else:
            z = torch.randn(2, 4, 8, 8, generator=torch.Generator()
                            .manual_seed(1))
            got = pipe.decode(z)
            want = ref.vae_decode(w["vae"], z, cfg)
            low = ref.vae_decode(w["vae"], z, cfg, ref.fp8)
    assert got.shape == want.shape
    assert gap(got, want) <= TOL[way]
    assert gap(low, want) > 100 * TOL[way]


def _conditioning(pipe, image):
    """The program's own conditioning of the image (uncond first)."""
    rgb = np.ascontiguousarray(image[..., [2, 1, 0]])
    with torch.inference_mode():
        neg, pos = pipe.encode_prompt("")
        feats = pipe.encode_image(rgb)[1]
        lat = pipe.encode_image_latents(rgb, size=SIZE)[1]
    return torch.cat([neg, pos]), feats, lat


def test_unet_eps_with_camera_and_image_prompt(both, image):
    """ε of the CFG pair at one timestep, on the program's own
    conditioning: text context, cameras, the Resampler's tokens and the
    image latent in each branch's last frame."""
    pipe, w, cfg = both
    text, feats, lat = _conditioning(pipe, image)
    kw = ref.unet_inputs(text, feats, lat, 4, elevation=0.0)
    x = torch.randn(10, 4, 16, 16, generator=torch.Generator().manual_seed(2))
    t = torch.full((10,), 481.0)
    with torch.inference_mode():
        got = pipe.unet(x, t, kw["context"], 5, camera=kw["camera"],
                        ip=kw["ip"], ip_img=kw["ip_img"])
    want = ref.unet(w["unet"], x, t, kw["context"], 5, kw["camera"], cfg,
                    kw["ip"], kw["ip_img"])
    low = ref.unet(w["unet"], x, t, kw["context"], 5, kw["camera"], cfg,
                   kw["ip"], kw["ip_img"], ref.fp8)
    for half in (slice(0, 5), slice(5, 10)):
        assert gap(got[half], want[half]) <= TOL["eps"]
        assert gap(low[half], want[half]) > 10 * TOL["eps"]


def test_ddim_loop(both, image):
    """The program's ``denoise`` (30 steps, guidance 5) against the plain
    loop, both driven from the same noise and conditioning."""
    pipe, w, cfg = both
    text, feats, lat = _conditioning(pipe, image)
    kw = ref.unet_inputs(text, feats, lat, 4, elevation=0.0)
    noise = torch.randn(5, 4, 16, 16, generator=torch.Generator()
                        .manual_seed(4))
    with torch.inference_mode():
        got = pipe.denoise(noise, kw["context"], kw["camera"], 30, 5.0, 5,
                           kw["ip"], kw["ip_img"])

    def eps(x, t):
        return ref.unet(w["unet"], x, torch.full((10,), float(t)),
                        kw["context"], 5, kw["camera"], cfg, kw["ip"],
                        kw["ip_img"])

    want = ref.denoise(eps, noise, 30, 5.0)
    assert gap(noise, want) > 0.1
    assert gap(got[:4], want[:4]) <= TOL["ddim"]


def test_image_to_views_whole(both, image):
    """``infer.image_to_views`` (recentre, white composite, the
    conditioning, 30 DDIM steps at guidance 5, the decoder, views [1, 2,
    3, 0] resized to the input size) against the plain path from the same
    BGRA image and the same initial noise; the control fails it."""
    pipe, w, cfg = both
    opt = get_config("nano").replace(input_size=48)
    with torch.inference_mode():
        got = infer.image_to_views(Small(pipe), image, opt, elevation=0.0)
    noise = torch.randn(5, 4, 16, 16, generator=torch.Generator()
                        .manual_seed(0))
    ids = torch.as_tensor(pipe.tokenizer(""))
    bgra = torch.as_tensor(image)
    want = ref.image_to_views(w, bgra, ids, noise, cfg, opt.input_size)
    assert got.shape == tuple(want.shape) == (4, 48, 48, 3)
    assert np.abs(got - want.numpy()).max() <= VIEW_TOL
    low = ref.image_to_views(w, bgra, ids, noise, cfg, opt.input_size,
                             q_clip=ref.bf16, q=ref.fp8)
    assert (low - want).abs().max() > 10 * VIEW_TOL

