"""The diffusion front-end of the port against lgm_tpu on the CPU: the
multi-view U-Net and the VAE against their goldens and their Flax twins
(parameters carried across by weights.diffusion_params_to_state_dicts,
f32, dense attention on both sides), the attention gate and its K1 route,
the whole pipeline against the composed goldens and against lgm_tpu's
MVDreamPipeline, image_to_views against lgm_tpu's single-image sequence,
the weight round trips, and the ``--image`` CLI.

Tolerances are lgm_tpu's golden tolerances: modules 1e-4·max(scale, 1) +
1e-5; the pipeline's final latents 1e-3 of their scale and its images
2e-3 (tests/test_golden_pipeline.py). The twins run on the port's
seeded parameters, carried to lgm_tpu by its own converter: PyTorch's
default initialization leaves no output layer at zero, as Flax's does
(and the goldens' reference models do), so ε is not 0."""

import dataclasses
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.diffusion import mv_unet as jmv
from lgm_tpu.diffusion import pipeline as jpipe
from lgm_tpu.diffusion.vae import AutoencoderKL as JaxVAE
from lgm_tpu.ops.mha import mha_kresident
from lgm_tpu.tools.convert_diffusion import (convert_component,
                                             unet_torch_to_flax,
                                             vae_torch_to_flax)
from lgm_tpu.utils import image as jimage
from lgm_tpu_torch import infer
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.diffusion import mv_unet
from lgm_tpu_torch.diffusion import pipeline as tpipe
from lgm_tpu_torch.diffusion.mv_unet import MultiViewUNetModel, attention
from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer
from lgm_tpu_torch.diffusion.vae import AutoencoderKL
from lgm_tpu_torch.ops.mha import kernel_takes
from lgm_tpu_torch.weights import (diffusion_params_to_state_dicts,
                                   flax_params_to_state_dict)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
FIX = os.path.join(ROOT, "tests", "fixtures", "clip_tokenizer")
_UNET_TINY = dict(model_channels=32, num_res_blocks=1,
                  attention_resolutions=(1, 2), channel_mult=(1, 2),
                  num_head_channels=16, context_dim=32)


def _check(y, y_ref, what):
    assert y.shape == y_ref.shape, (what, y.shape, y_ref.shape)
    scale = np.abs(y_ref).max()
    err = np.abs(y - y_ref).max()
    assert err <= 1e-4 * max(scale, 1.0) + 1e-5, (what, err, scale)


def _group(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _load(module, sd):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def test_configs_match_lgm_tpu():
    assert sorted(tpipe.CONFIGS) == sorted(jpipe.CONFIGS)
    for name, cfg in tpipe.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jpipe.CONFIGS[name]), name


@pytest.mark.parametrize("name,ip_dim", [("mvunet_tiny", 0),
                                         ("mvunet_ip_tiny", 8)])
def test_mv_unet_matches_golden(name, ip_dim):
    data = np.load(os.path.join(GOLD, name + ".npz"))
    net = _load(MultiViewUNetModel(ip_dim=ip_dim, **_UNET_TINY),
                _group(data, "sd/"))
    kw, F = {}, 4
    if ip_dim:
        kw, F = dict(ip=torch.as_tensor(data["ip"]),
                     ip_img=torch.as_tensor(data["ip_img"])), 5
    with torch.no_grad():
        y = net(torch.as_tensor(data["x"]), torch.as_tensor(data["t"]),
                torch.as_tensor(data["context"]), F,
                camera=torch.as_tensor(data["camera"]), **kw)
    _check(y.numpy(), data["output"], name)


def _port_state(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("ip_dim", [0, 4])
def test_mv_unet_matches_jax(ip_dim):
    """lgm_tpu's MultiViewUNetModel (f32) on a CFG pair of F frames, with
    the port's seeded parameters carried across by lgm_tpu's own
    converter (``convert_component``); the ip branch with 48-wide image
    features."""
    F = 5 if ip_dim else 4
    B, lat = 2, 8
    rng = np.random.default_rng(ip_dim)
    x = rng.normal(0, 1, (B * F, lat, lat, 4)).astype(np.float32)
    t = rng.integers(0, 1000, B * F).astype(np.float32)
    ctx = rng.normal(0, 1, (B * F, 7, 32)).astype(np.float32)
    cam = rng.normal(0, 1, (B * F, 16)).astype(np.float32)
    kw, tkw = {}, {}
    if ip_dim:
        ip = rng.normal(0, 1, (B * F, 5, 48)).astype(np.float32)
        ip_img = rng.normal(0, 1, (B, lat, lat, 4)).astype(np.float32)
        kw = dict(ip=jnp.asarray(ip), ip_img=jnp.asarray(ip_img))
        tkw = dict(ip=torch.as_tensor(ip),
                   ip_img=torch.as_tensor(ip_img.transpose(0, 3, 1, 2)))
    cam = jnp.asarray(cam)
    torch.manual_seed(ip_dim)
    net = MultiViewUNetModel(ip_dim=ip_dim, ip_embedding_dim=48,
                             **_UNET_TINY).eval()
    with torch.no_grad():
        y = net(torch.as_tensor(x.transpose(0, 3, 1, 2)), torch.as_tensor(t),
                torch.as_tensor(ctx), F,
                camera=torch.as_tensor(np.asarray(cam)), **tkw)
    jnet = jmv.MultiViewUNetModel(ip_dim=ip_dim, dtype=jnp.float32,
                                  **_UNET_TINY)
    params = convert_component(_port_state(net), unet_torch_to_flax)
    y_ref = np.asarray(jax.jit(
        lambda p, *a: jnet.apply({"params": p}, *a, F, camera=cam, **kw))(
            params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    assert np.abs(y_ref).max() > 1e-2
    _check(y.numpy().transpose(0, 2, 3, 1), y_ref, f"ip_dim {ip_dim}")


def test_vae_matches_golden_and_jax():
    """vae_tiny.npz (diffusers' names, an independent torch mirror), then
    lgm_tpu's AutoencoderKL on the port's seeded parameters."""
    data = np.load(os.path.join(GOLD, "vae_tiny.npz"))
    vae = _load(AutoencoderKL((32, 64)), _group(data, "sd/"))
    with torch.no_grad():
        mean, logvar = vae.encode(torch.as_tensor(data["x"]))
        rgb = vae.decode(torch.as_tensor(data["z"]))
    _check(torch.cat([mean, logvar], 1).numpy(), data["moments"], "moments")
    _check(rgb.numpy(), data["rgb"], "rgb")

    torch.manual_seed(2)
    vae = AutoencoderKL((32, 64)).eval()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        mean, logvar = vae.encode(torch.as_tensor(x.transpose(0, 3, 1, 2)))
        rgb = vae.decode(mean)
    jvae = JaxVAE(block_out_channels=(32, 64), dtype=jnp.float32)
    params = {"params": convert_component(_port_state(vae),
                                          vae_torch_to_flax)}
    jm, jl = jax.jit(lambda p, a: jvae.apply(p, a, method=jvae.encode))(
        params, jnp.asarray(x))
    jrgb = jax.jit(lambda p, z: jvae.apply(p, z, method=jvae.decode))(
        params, jm)
    for ours, ref, what in ((mean, jm, "mean"), (logvar, jl, "logvar"),
                            (rgb, jrgb, "decode")):
        _check(ours.numpy().transpose(0, 2, 3, 1), np.asarray(ref), what)


# (dtype, B, heads, Nq, Nk, head dim): MVDream's and ImageDream's level-0
# self-attention at 256² (S = F·32², BH 10, D 64), and the cases where
# one condition fails: level 1 (S 1024, logits 42 MB), a long logits
# transient at S 1024, Nq % 512, Nq != Nk (cross-attention), f32, head
# dims K1 does not take or lgm_tpu does not send.
_GATE = [(torch.bfloat16, 2, 5, 4096, 4096, 64),
         (torch.bfloat16, 2, 5, 5120, 5120, 64),
         (torch.bfloat16, 1, 4, 2048, 2048, 32),
         (torch.bfloat16, 2, 10, 1024, 1024, 64),
         (torch.bfloat16, 2, 100, 1024, 1024, 64),
         (torch.bfloat16, 2, 5, 2176, 2176, 64),
         (torch.bfloat16, 2, 5, 4096, 93, 64),
         (torch.float32, 2, 5, 4096, 4096, 64),
         (torch.bfloat16, 2, 5, 4096, 4096, 48),
         (torch.bfloat16, 2, 5, 4096, 4096, 128),
         (torch.bfloat16, 2, 20, 4096, 4096, 16)]


@pytest.mark.parametrize("dtype,B,heads,Nq,Nk,hd", _GATE)
def test_attention_gate_matches_lgm_tpu(dtype, B, heads, Nq, Nk, hd,
                                        monkeypatch):
    """The route is K1 exactly where lgm_tpu's _attention takes its
    K-resident kernel and K1 takes the input, read from dtype and shape
    (a CPU tensor takes the card's route)."""
    logits_bytes = B * heads * Nq * Nk * 2
    want = (Nq == Nk and Nq % 512 == 0
            and (Nq >= 2048 or logits_bytes > 2e8) and hd <= 64
            and kernel_takes(dtype, Nq, Nk, hd, hd ** -0.5))
    assert mv_unet.kernel_route(dtype, B, heads, Nq, Nk, hd) == want
    called = []
    monkeypatch.setattr(mv_unet, "mha",
                        lambda q, *a: called.append("kernel") or q)
    monkeypatch.setattr(mv_unet, "dense_attention",
                        lambda q, *a: called.append("dense") or q)
    q = torch.zeros(B, Nq, heads * hd, dtype=dtype, device="meta")
    k = torch.zeros(B, Nk, heads * hd, dtype=dtype, device="meta")
    attention(q, k, k, heads)
    assert called == ["kernel" if want else "dense"]


def test_k1_route_matches_kresident_and_dense():
    """The K1 route in bf16 at a shape the gate sends to it (S 2048, D 64)
    against lgm_tpu's mha_kresident (the TPU kernel in interpret mode) and
    jax.nn.dot_product_attention: one bf16 rounding step of the scale
    against the kernel, which rounds P where K1 does, two against the
    dense path, which rounds the normalized P."""
    B, heads, S, D = 1, 2, 2048, 64
    assert mv_unet.kernel_route(torch.bfloat16, B, heads, S, S, D)
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(0, 1, (B, S, heads * D)).astype(np.float32)
               for _ in range(3))
    bf = [torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)]
    o = attention(*bf, heads).float().numpy()

    def bh(x):  # [B, S, H*D] -> [B*H, S, D]
        return jnp.asarray(x, jnp.bfloat16).reshape(B, S, heads, D) \
            .transpose(0, 2, 1, 3).reshape(B * heads, S, D)

    o_kres = np.asarray(mha_kresident(bh(q), bh(k), bh(v), D ** -0.5)
                        .astype(jnp.float32)).reshape(B, heads, S, D) \
        .transpose(0, 2, 1, 3).reshape(B, S, heads * D)
    o_dense = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(x, jnp.bfloat16).reshape(B, S, heads, D)
          for x in (q, k, v))).astype(jnp.float32)).reshape(B, S, heads * D)
    scale = np.abs(o_kres).max()
    assert np.abs(o - o_kres).max() <= 2.0 ** -8 * scale
    assert np.abs(o - o_dense).max() <= 2.0 ** -7 * scale


def _regen_vision_sd(data):
    """The golden's CLIP vision weights, regenerated from its seed as
    tests/test_golden_pipeline.py does (checksum checked there)."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    cfg = {k[len("vision_cfg/"):]: int(data[k]) for k in data.files
           if k.startswith("vision_cfg/")}
    torch.manual_seed(int(data["vision_seed"]))
    m = CLIPVisionModel(CLIPVisionConfig(**cfg))
    return {k: v.numpy() for k, v in m.state_dict().items()}


def _run_pipe(pipe, data, image, output_type="latent"):
    return pipe(prompt=data["prompt"].item().decode(),
                negative_prompt=data["negative"].item().decode(),
                image=image, height=32, width=32,
                elevation=float(data["elevation"]),
                num_inference_steps=int(data["steps"]),
                guidance_scale=float(data["guidance"]),
                latents=data["latents0"].transpose(0, 2, 3, 1),
                output_type=output_type)


def _check_pipe(lat, imgs, ref_lat, ref_imgs):
    scale = np.abs(ref_lat).max()
    assert np.abs(lat - ref_lat).max() <= 1e-3 * scale
    assert np.abs(imgs - ref_imgs).max() <= 2e-3


@pytest.mark.parametrize("name,gold", [("tiny-pipe", "pipeline_tiny"),
                                       ("tiny-pipe-ip", "pipeline_ip_tiny")])
def test_pipeline_matches_golden(name, gold):
    """The composed goldens (torch oracle: reference U-Net, a VAE mirror,
    torch CLIP, a hand DDIM): the text path and the image path from the
    goldens' initial latents, 3 steps, the goldens' state dicts loaded as
    they are."""
    data = np.load(os.path.join(GOLD, gold + ".npz"))
    ip = name.endswith("-ip")
    pipe = tpipe.MVDreamPipeline(tpipe.CONFIGS[name], device="cpu")
    sds = {"unet": _group(data, "unet_sd/"), "vae": _group(data, "vae_sd/"),
           "text_encoder": _group(data, "text_sd/")}
    if ip:
        sds["image_encoder"] = _regen_vision_sd(data)
    pipe.load_state_dicts(sds)
    np.testing.assert_allclose(
        mv_unet.get_camera(4, float(data["elevation"]), extra_view=ip),
        data["camera"], atol=1e-5)
    lat = _run_pipe(pipe, data, data["image"] if ip else None)
    _check_pipe(lat, pipe.decode_latents(lat),
                data["latents_final"].transpose(0, 2, 3, 1),
                data["images"].transpose(0, 2, 3, 1))


@pytest.fixture(scope="module")
def pipes():
    """lgm_tpu's MVDreamPipeline at "tiny-test-ip" in f32 and the port's
    pipeline on the same parameters: the port's seeded U-Net and VAE
    carried to lgm_tpu by its converter, and Flax CLIP towers initialized
    as lgm_tpu's from_config does, carried to the port."""
    cfg = dataclasses.replace(tpipe.CONFIGS["tiny-test-ip"],
                              compute_dtype="float32")
    torch.manual_seed(5)
    tp = tpipe.MVDreamPipeline(cfg, device="cpu")
    # The uncond branch's ip frame is all zeros. With a bias on the stem
    # conv it enters the first GroupNorm (one channel a group) as a
    # constant map, whose f32 variance is rounding noise that 1/sqrt(eps)
    # amplifies: f32 results of any two implementations then differ far
    # beyond the tolerance (the port 4e-4, lgm_tpu 1.5e-2 from an f64
    # run, one U-Net call). A zero stem bias keeps that frame exactly 0
    # there, and both pipelines well conditioned.
    with torch.no_grad():
        tp.unet.input_blocks[0][0].bias.zero_()
    jp = jpipe.MVDreamPipeline(
        jpipe.PipelineConfig(**dataclasses.asdict(cfg)), params={})
    jp.params = {
        "unet": convert_component(_port_state(tp.unet), unet_torch_to_flax),
        "vae": convert_component(_port_state(tp.vae), vae_torch_to_flax),
        "text_encoder": jp._text_model.init_weights(
            jax.random.PRNGKey(1), (1, cfg.max_tokens)),
        "image_encoder": jp._vision_model.init_weights(
            jax.random.PRNGKey(2), (1, cfg.image_size, cfg.image_size, 3)),
    }
    sds = diffusion_params_to_state_dicts(jax.tree_util.tree_map(
        np.asarray, {k: jp.params[k] for k in ("text_encoder",
                                               "image_encoder")}))
    tp.load_state_dicts(sds)
    return jp, tp


def test_pipeline_matches_jax(pipes):
    """The image path end to end (CLIP text and vision, the VAE encode,
    CFG, the Resampler, the ip frame, 3 DDIM steps, the decode) against
    lgm_tpu's on the same parameters and initial latents: the four views
    it generates. The fifth frame's latent is not compared: the U-Net
    overwrites it with the image latent at every call, image_to_views
    drops it, and its update comes from the uncond branch's zero frame,
    still ill-conditioned in f32 deeper in the net (lgm_tpu and the port
    differ by 3e-4 there after one step, 0.05 after three)."""
    jp, tp = pipes
    rng = np.random.default_rng(11)
    image = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    lat0 = rng.normal(0, 1, (5, 16, 16, 4)).astype(np.float32)
    kw = dict(prompt="a red chair", negative_prompt="blurry", image=image,
              height=32, width=32, elevation=15.0, num_inference_steps=3,
              guidance_scale=5.0, latents=lat0)
    ref = np.asarray(jp(output_type="latent", **kw))[:4]
    lat = tp(output_type="latent", **kw)[:4]
    assert np.abs(ref - lat0[:4]).max() > 1e-2
    _check_pipe(lat, tp.decode_latents(lat), ref, jp.decode_latents(ref))
    neg, pos = jp.encode_prompt("a red chair", "blurry")
    tneg, tpos = tp.encode_prompt("a red chair", "blurry")
    _check(tpos.numpy(), pos, "prompt")
    _check(tneg.numpy(), neg, "negative prompt")


class _StubPipe:
    """Records what image_to_views hands the pipeline; returns fixed
    views."""

    def __init__(self, mv):
        self.mv, self.calls = mv, []

    def __call__(self, **kw):
        self.calls.append(kw)
        return self.mv


@pytest.mark.parametrize("channels", [4, 3])
def test_image_to_views_matches_lgm_tpu_sequence(channels):
    """lgm_tpu/infer.py:352-381 on the same BGRA (BGR) image and the same
    pipeline output: BGRA -> RGBA, recenter on alpha > 0,
    white compositing (or BGR -> RGB), the pipeline at 30 steps and
    guidance 5.0 with an empty prompt, views [1, 2, 3, 0], cv2.resize to
    the input size."""
    rng = np.random.default_rng(channels)
    image = rng.uniform(0, 1, (48, 40, channels)).astype(np.float32)
    if channels == 4:
        image[..., 3] = 0.0
        image[8:40, 5:30, 3] = rng.uniform(0.1, 1, (32, 25))
    mv = rng.uniform(0, 1, (5, 64, 64, 3)).astype(np.float32)
    opt = get_config("nano")
    stub = _StubPipe(mv)
    views = infer.image_to_views(stub, image, opt, elevation=10.0)

    if channels == 4:
        rgba = image[..., [2, 1, 0, 3]]
        rgba = jimage.recenter(rgba, rgba[..., 3] > 0, border_ratio=0.2)
        want_img = jimage.rgba_to_rgb_white(rgba)
    else:
        want_img = image[..., [2, 1, 0]]
    (call,) = stub.calls
    assert np.abs(call["image"] - want_img).max() <= 1e-5
    assert (call["prompt"], call["elevation"], call["num_inference_steps"],
            call["guidance_scale"]) == ("", 10.0, 30, 5.0)
    want = np.stack([cv2.resize(m, (opt.input_size, opt.input_size))
                     for m in mv[[1, 2, 3, 0]]])
    assert views.shape == want.shape == (4, opt.input_size,
                                         opt.input_size, 3)
    assert np.abs(views - want).max() <= 1e-5


def test_weights_round_trip_through_convert_diffusion():
    """A reference state dict (the goldens' U-Net with the ip branch, and
    diffusers' VAE) -> lgm_tpu's convert_component -> the port's
    inverse gives back the same tensors under the same names."""
    for gold, comp, mapper in (("mvunet_ip_tiny", "unet", unet_torch_to_flax),
                               ("vae_tiny", "vae", vae_torch_to_flax)):
        sd = _group(np.load(os.path.join(GOLD, gold + ".npz")), "sd/")
        back = diffusion_params_to_state_dicts(
            {comp: convert_component(sd, mapper)})[comp]
        assert sorted(back) == sorted(sd), gold
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("comp,leaf", [
    ("lgm", "embedding"), ("lgm", "latents"), ("unet", "class_embedding"),
    ("vae", "latents"), ("text_encoder", "latents")])
def test_weight_converters_refuse_unknown_leaves(comp, leaf):
    """A Flax leaf that a tree does not hold is an error, not a bare
    parameter under a made-up name: only the U-Net's Resampler latents and
    the CLIP vision tower's class embedding are bare, only CLIP has
    embedding tables."""
    tree = {"block": {leaf: np.zeros(2, np.float32)}}
    with pytest.raises(KeyError, match="unexpected Flax leaf"):
        if comp == "lgm":
            flax_params_to_state_dict(tree)
        else:
            diffusion_params_to_state_dicts({comp: tree})


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_save_pretrained_round_trip(fmt, tmp_path, monkeypatch):
    """save_pretrained -> from_pretrained on a tiny diffusers-layout
    directory: the config read back from the components' config.json,
    every tensor, and the tokenizer's ids."""
    if fmt == "bin":
        monkeypatch.setattr(tpipe, "_has_safetensors", lambda: False)
    pipe = tpipe.MVDreamPipeline.from_config(
        "tiny-test-ip", seed=1, device="cpu",
        tokenizer=CLIPTokenizer(FIX, 16))
    pipe.save_pretrained(str(tmp_path / "ckpt"))
    names = sorted(os.listdir(tmp_path / "ckpt" / "unet"))
    assert names == ["config.json", "diffusion_pytorch_model."
                     + fmt], names
    back = tpipe.MVDreamPipeline.from_pretrained(str(tmp_path / "ckpt"),
                                                 device="cpu")
    assert back.cfg == dataclasses.replace(pipe.cfg,
                                           allow_hash_tokenizer=False)
    for name, module in pipe.modules().items():
        theirs = back.modules()[name].state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(v, theirs[k]), (name, k)
    np.testing.assert_array_equal(back.tokenizer("an owl statue"),
                                  pipe.tokenizer("an owl statue"))


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_load_state_dicts_takes_tensors_and_arrays(kind):
    """``load_state_dicts`` takes CPU tensors as they are and numpy arrays
    through ``torch.as_tensor``: the same weights each way
    (``tests/test_torch_kernels_gpu.py`` holds CUDA tensors to it)."""
    src = tpipe.MVDreamPipeline.from_config("tiny-test-ip", seed=1,
                                            device="cpu")
    sds = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
           for name, m in src.modules().items()}
    if kind == "numpy":
        sds = {name: {k: v.numpy() for k, v in sd.items()}
               for name, sd in sds.items()}
    dst = tpipe.MVDreamPipeline.from_config("tiny-test-ip", seed=2,
                                            device="cpu")
    dst.load_state_dicts(sds)
    for name, module in dst.modules().items():
        want = src.modules()[name].state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)


def test_prompt_needs_a_real_tokenizer():
    """Without a tokenizer/ directory a published-size config refuses to
    encode a prompt (the hashing stand-in is for the tiny configs)."""
    cfg = dataclasses.replace(tpipe.CONFIGS["tiny-test"],
                              allow_hash_tokenizer=False)
    with pytest.raises(RuntimeError, match="tokenizer"):
        tpipe.MVDreamPipeline(cfg, device="cpu").encode_prompt("a chair")


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "lgm_tpu_torch.infer"]
                          + args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_image_writes_ply(tmp_path):
    """``infer nano --image x.png --diffusion-ckpt DIR --device cpu``: a
    PNG written with cv2 and a tiny ImageDream directory (a VAE of four
    levels, so its latents are 32² at the pipeline's 256²; a U-Net of
    three levels with attention at 8² only) -> .ply and orbit. Without
    ``--device cpu`` on a host with no GPU it raises; ``--image`` and
    ``--mv-images`` exclude each other."""
    cfg = dataclasses.replace(tpipe.CONFIGS["tiny-test-ip"],
                              channel_mult=(1, 2, 2),
                              attention_resolutions=(4,),
                              vae_channels=(32, 32, 32, 32),
                              compute_dtype="float32")
    torch.manual_seed(0)
    tpipe.MVDreamPipeline(cfg, device="cpu", tokenizer=CLIPTokenizer(
        FIX, cfg.max_tokens)).save_pretrained(str(tmp_path / "dream"))
    rng = np.random.default_rng(0)
    bgra = np.zeros((80, 64, 4), np.uint8)
    bgra[16:70, 10:50] = rng.integers(0, 256, (54, 40, 4))
    bgra[16:70, 10:50, 3] = 255
    cv2.imwrite(str(tmp_path / "x.png"), bgra)
    args = ["nano", "--image", "x.png", "--diffusion-ckpt", "dream",
            "--workspace", "ws"]
    out = _cli(args + ["--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.getsize(tmp_path / "ws" / "x.ply") > 0
    out = _cli(args, tmp_path)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = _cli(args + ["--mv-images", "a", "b", "c", "d"], tmp_path)
    assert out.returncode == 2 and "not allowed with" in out.stderr
