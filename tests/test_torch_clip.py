"""The diffusion front-end's host side and its CLIP towers in the port,
against what lgm_tpu runs: the resize against cv2 (all three
interpolations lgm_tpu uses), recenter and compositing against
lgm_tpu.utils.image, DDIM against lgm_tpu.diffusion.ddim, the CLIP BPE
tokenizer against transformers.CLIPTokenizer, and the CLIP towers against
the clip_tiny golden and against transformers' Flax towers as lgm_tpu
builds them, parameters carried across by
weights.diffusion_params_to_state_dicts. Tolerances: 1e-5 for the resize
(images in [0, 1]), lgm_tpu's golden tolerance for the towers."""

import json
import os

import cv2
import numpy as np
import pytest

import jax
import torch

from lgm_tpu.diffusion.ddim import DDIMScheduler as JaxDDIM
from lgm_tpu.utils import image as jimage
from lgm_tpu_torch.diffusion.clip import CLIPTextModel, CLIPVisionModel
from lgm_tpu_torch.diffusion.ddim import DDIMScheduler
from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer, _bytes_to_unicode
from lgm_tpu_torch.utils import image as timage
from lgm_tpu_torch.utils.resize import resize
from lgm_tpu_torch.weights import diffusion_params_to_state_dicts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures", "clip_tokenizer")
_CV2 = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
        "area": cv2.INTER_AREA}
# (source H, W) -> (destination h, w): shrinking, enlarging, odd sizes,
# integer and fractional ratios, one axis growing while the other
# shrinks, identity, and lgm_tpu's own uses (recenter's crop, CLIP's 224,
# the VAE's 256, LGM's 256 input views).
_SIZES = [((37, 53), (17, 29)), ((37, 53), (101, 77)), ((64, 64), (32, 32)),
          ((64, 64), (128, 128)), ((101, 77), (33, 150)),
          ((20, 31), (20, 31)), ((512, 512), (224, 224)),
          ((409, 301), (256, 256)), ((256, 256), (64, 64)), ((7, 5), (3, 9))]


@pytest.mark.parametrize("mode", sorted(_CV2))
def test_resize_matches_cv2(mode):
    rng = np.random.default_rng(len(mode))
    for (h, w), (oh, ow) in _SIZES:
        for c in (None, 3, 4):
            shape = (h, w) if c is None else (h, w, c)
            img = rng.uniform(0, 1, shape).astype(np.float32)
            ours = resize(img, (ow, oh), mode)
            ref = cv2.resize(img, (ow, oh), interpolation=_CV2[mode])
            assert ours.shape == ref.shape and ours.dtype == np.float32
            err = np.abs(ours - ref).max()
            assert err <= 1e-5, (mode, shape, (oh, ow), err)


@pytest.mark.parametrize("shape,box", [((64, 48), (10, 50, 5, 30)),
                                       ((50, 80), (3, 12, 40, 77)),
                                       ((96, 96), (30, 34, 20, 90))])
def test_recenter_and_compositing_match_jax(shape, box):
    """recenter (crop, INTER_AREA resize, centred paste) on a seeded RGBA
    with a rectangular alpha, then the white compositing and the 2x2
    preview grid."""
    rng = np.random.default_rng(shape[0])
    rgba = rng.uniform(0, 1, shape + (4,)).astype(np.float32)
    y0, y1, x0, x1 = box
    rgba[..., 3] = 0.0
    rgba[y0:y1, x0:x1, 3] = rng.uniform(0.2, 1, (y1 - y0, x1 - x0))
    mask = rgba[..., 3] > 0
    ours = timage.recenter(rgba, mask, border_ratio=0.2)
    ref = jimage.recenter(rgba, mask, border_ratio=0.2)
    assert ours.shape == ref.shape == (max(shape),) * 2 + (4,)
    assert np.abs(ours - ref).max() <= 1e-5
    np.testing.assert_array_equal(
        timage.recenter(rgba, np.zeros(shape, bool)),
        jimage.recenter(rgba, np.zeros(shape, bool)))
    np.testing.assert_allclose(timage.rgba_to_rgb_white(ref),
                               jimage.rgba_to_rgb_white(ref), atol=1e-7)
    mv = rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.mv_grid_2x2(mv),
                                  jimage.mv_grid_2x2(mv))


@pytest.mark.parametrize("steps", [3, 30, 50])
def test_ddim_matches_jax(steps):
    """set_timesteps, the host-side step arrays the pipeline's loop reads
    (as lgm_tpu's __call__ computes them), step and add_noise."""
    ours, ref = DDIMScheduler(), JaxDDIM()
    np.testing.assert_array_equal(ours.alphas_cumprod, ref.alphas_cumprod)
    ours.set_timesteps(steps)
    ref.set_timesteps(steps)
    np.testing.assert_array_equal(ours.timesteps, ref.timesteps)
    ts, a_t, a_prev = ours.step_arrays()
    prev = ts - 1000 // steps
    np.testing.assert_array_equal(a_t, ref.alphas_cumprod[ts])
    np.testing.assert_array_equal(a_prev, np.where(
        prev >= 0, ref.alphas_cumprod[np.maximum(prev, 0)],
        ref.final_alpha_cumprod).astype(np.float32))
    rng = np.random.default_rng(steps)
    x, eps, noise = (rng.normal(size=(3, 4, 4, 4)).astype(np.float32)
                     for _ in range(3))
    for t in (int(ts[0]), int(ts[-1])):
        np.testing.assert_allclose(ours.step(eps, t, x),
                                   np.asarray(ref.step(eps, t, x)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ours.step(eps, t, x, eta=0.5, noise=noise),
            np.asarray(ref.step(eps, t, x, eta=0.5, noise=noise)),
            rtol=1e-6, atol=1e-6)
    t = np.array([1, 500, 999])
    np.testing.assert_allclose(ours.add_noise(x, eps, t),
                               ref.add_noise(x, eps, t), rtol=1e-6)


_PROMPTS = ["an owl statue", "An OWL's statue, 3 chairs!", "a red chair",
            "café naïve résumé", "hello   world\t\n2024 v2.0 :) __init__",
            "", "x" * 40, "it's we're they've I'm you'll he'd",
            "Ünïcödé ñ 北京 猫", "owl<|endoftext|>owl", "²½Ⅻ 12 ab²cd"]


def _byte_vocab(path):
    """A vocabulary with every byte symbol (alone and word-final), a few
    merges and the two special tokens, so every prompt tokenizes without
    unknowns."""
    symbols = list(_bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>"
                                                   for s in symbols])}
    merges = ["o w", "ow l</w>", "c h", "a i", "ch ai", "r </w>", "2 0"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(path)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("\n".join(["#version: 0.2"] + merges) + "\n")
    return str(path)


@pytest.mark.parametrize("vocab", ["fixture", "bytes", "bytes_pad"])
def test_tokenizer_matches_transformers(vocab, tmp_path):
    """Ids equal transformers.CLIPTokenizer's as lgm_tpu calls it
    (padding to max_length, truncation), over ASCII, accented, digit,
    punctuation, CJK, special-token and non-decimal-numeral prompts; on
    the committed fixture, on a byte-complete vocabulary, and with a pad
    token of its own ("!", as Stable Diffusion 2's tokenizer sets it)."""
    from transformers import CLIPTokenizer as HFTokenizer

    path = FIX if vocab == "fixture" else _byte_vocab(tmp_path / "tok")
    if vocab == "bytes_pad":
        with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
            json.dump({"pad_token": "!", "bos_token": {
                "content": "<|startoftext|>"}}, f)
    hf = HFTokenizer.from_pretrained(path)
    for length in (16, 24):
        ours = CLIPTokenizer(path, length)
        for p in _PROMPTS:
            want = np.asarray(hf(p, padding="max_length", max_length=length,
                                 truncation=True,
                                 return_tensors="np").input_ids)
            got = ours(p)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want, err_msg=repr(p))


def test_tokenizer_hand_derived_ids():
    """tests/test_tokenizer.py's hand-derived case (lgm_tpu's
    _maybe_tokenizer on the fixture): bos 54, merged owl</w> 53, eos 55
    and eos padding."""
    tok = CLIPTokenizer(FIX, 16)
    np.testing.assert_array_equal(
        tok("an owl statue")[0],
        [54, 0, 27, 53, 36, 38, 0, 38, 40, 9, 55, 55, 55, 55, 55, 55])
    np.testing.assert_array_equal(tok("owl")[0][:3], [54, 53, 55])


def _check(y, y_ref, what):
    assert y.shape == y_ref.shape, (what, y.shape, y_ref.shape)
    scale = np.abs(y_ref).max()
    err = np.abs(y - y_ref).max()
    assert err <= 1e-4 * max(scale, 1.0) + 1e-5, (what, err, scale)


def _load(module, sd):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                           strict=True)


def test_clip_towers_match_golden():
    """clip_tiny.npz: torch CLIP outputs, and the same weights as Flax
    trees (``tp/``, ``vp/``) carried into the port's towers."""
    data = np.load(os.path.join(HERE, "golden", "clip_tiny.npz"))

    def tree(prefix):
        out = {}
        for k in data.files:
            if k.startswith(prefix):
                node = out
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = data[k]
        return out

    sds = diffusion_params_to_state_dicts(
        {"text_encoder": tree("tp/"), "image_encoder": tree("vp/")})
    text = CLIPTextModel(500, 64, 3, 4, 16).eval()
    vision = CLIPVisionModel(64, 3, 4, 32, 16).eval()
    _load(text, sds["text_encoder"])
    _load(vision, sds["image_encoder"])
    with torch.no_grad():
        y_text = text(torch.as_tensor(data["ids"])).numpy()
        y_vis = vision(torch.as_tensor(
            data["img_nhwc"].transpose(0, 3, 1, 2))).numpy()
    _check(y_text, data["y_text"], "text last_hidden_state")
    _check(y_vis, data["y_vis"], "vision hidden_states[-2]")


def test_clip_towers_match_flax():
    """The Flax towers exactly as lgm_tpu's pipeline builds and calls them
    (``_build_clip``; ``last_hidden_state``, ``hidden_states[-2]``),
    seeded random weights and inputs, carried across."""
    from lgm_tpu.diffusion.pipeline import MVDreamPipeline, PipelineConfig

    cfg = PipelineConfig(vocab_size=300, text_hidden=48, text_layers=2,
                         text_heads=3, max_tokens=12, vision_hidden=48,
                         vision_layers=3, vision_heads=3, image_size=28,
                         patch_size=14)
    jtext, jvision = MVDreamPipeline._build_clip(cfg)
    tp = jtext.init_weights(jax.random.PRNGKey(1), (1, 12))
    vp = jvision.init_weights(jax.random.PRNGKey(2), (1, 28, 28, 3))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 300, (2, 12))
    img = rng.normal(0, 1, (2, 28, 28, 3)).astype(np.float32)
    y_text = np.asarray(jtext.module.apply(
        {"params": tp}, ids, np.ones_like(ids),
        np.broadcast_to(np.arange(12), (2, 12))).last_hidden_state)
    y_vis = np.asarray(jvision.module.apply(
        {"params": vp}, img, output_hidden_states=True).hidden_states[-2])
    sds = diffusion_params_to_state_dicts(jax.tree_util.tree_map(
        np.asarray, {"text_encoder": tp, "image_encoder": vp}))
    text = CLIPTextModel(300, 48, 2, 3, 12).eval()
    vision = CLIPVisionModel(48, 3, 3, 28, 14).eval()
    _load(text, sds["text_encoder"])
    _load(vision, sds["image_encoder"])
    with torch.no_grad():
        _check(text(torch.as_tensor(ids)).numpy(), y_text, "text")
        _check(vision(torch.as_tensor(img.transpose(0, 3, 1, 2))).numpy(),
               y_vis, "vision")
