"""MVDream / ImageDream multi-view diffusion pipeline in PyTorch.

Port of ``lgm_tpu/diffusion/pipeline.py`` (ref: mvdream/
pipeline_mvdream.py:23-558): the multi-view U-Net, the VAE and the two
CLIP towers of this package, driven by a DDIM loop with classifier-free
guidance (uncond first) and per-frame camera conditioning.

Text path (``mvdream``): 4 frames, text context only. Image path
(``imagedream``): 4 + 1 frames; CLIP image features feed the Resampler
(zero features for the uncond branch) and the VAE latent of the image
replaces the last frame of the cond branch (zeros in the uncond one).

The denoising loop runs on the device as a plain Python loop, the
counterpart of ``lgm_tpu``'s ``lax.scan``: timesteps and alpha-bar pairs
are computed on the host once (``DDIMScheduler.step_arrays``) and moved
to the device before the loop, so no step reads back from it.

``from_config(name, seed, device)`` initializes every module from
PyTorch's default initialization under ``seed``, and then gives the U-Net
the zeros of ``lgm_tpu``'s initialization (``mv_unet.init_like_lgm_tpu_``:
every bias, and the output layers, so the untrained U-Net predicts ε = 0,
as the finetune expects of its starting model); ``from_pretrained``
reads the published diffusers layout (``unet/``, ``vae/``,
``text_encoder/``, ``image_encoder/``, ``tokenizer/``, each with its
``config.json``), which ``save_pretrained`` writes. ``latents`` injects
the initial noise, as in ``lgm_tpu``; the port's own noise comes from a
``torch.Generator`` and cannot equal ``jax.random``'s.

Public arrays keep ``lgm_tpu``'s layout: images and ``latents`` are numpy
NHWC ([F, H, W, 3], [F, H/f, W/f, 4]); inside, the modules run NCHW.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lgm_tpu_torch.diffusion.clip import CLIPTextModel, CLIPVisionModel
from lgm_tpu_torch.diffusion.ddim import DDIMScheduler
from lgm_tpu_torch.diffusion.mv_unet import (MultiViewUNetModel, get_camera,
                                             init_like_lgm_tpu_)
from lgm_tpu_torch.diffusion.tokenizer import (CLIPTokenizer, HashTokenizer,
                                               load_tokenizer)
from lgm_tpu_torch.diffusion.vae import SCALING_FACTOR, AutoencoderKL
from lgm_tpu_torch.infer import resolve_device
from lgm_tpu_torch.models.unet import use_full_float32
from lgm_tpu_torch.utils.resize import resize

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # U-Net
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_res_blocks: int = 2
    num_head_channels: int = 64
    context_dim: int = 1024
    ip_dim: int = 0            # 16 for ImageDream
    ip_weight: float = 1.0
    # VAE
    vae_channels: Tuple[int, ...] = (128, 256, 512, 512)
    # CLIP text
    text_hidden: int = 1024
    text_layers: int = 23
    text_heads: int = 16
    vocab_size: int = 49408
    max_tokens: int = 77
    # CLIP vision (ImageDream's ip features, ViT-H/14)
    vision_hidden: int = 1280
    vision_layers: int = 32
    vision_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    # Compute dtype of the U-Net and the VAE (CLIP runs in f32).
    compute_dtype: str = "bfloat16"
    # Only the tiny test configs may encode prompts with HashTokenizer.
    allow_hash_tokenizer: bool = False


_TINY = dict(model_channels=32, channel_mult=(1, 2),
             attention_resolutions=(1, 2), num_res_blocks=1,
             num_head_channels=16, context_dim=32, vae_channels=(32, 64),
             text_hidden=32, text_layers=2, text_heads=2, vocab_size=1000,
             max_tokens=16, image_size=32, patch_size=16,
             allow_hash_tokenizer=True)

# The package's own copy of ``lgm_tpu``'s table.
CONFIGS = {
    "mvdream": PipelineConfig(),
    "imagedream": PipelineConfig(ip_dim=16),
    "tiny-test": PipelineConfig(vision_hidden=48, vision_layers=2,
                                vision_heads=2, **_TINY),
    "tiny-test-ip": PipelineConfig(vision_hidden=48, vision_layers=2,
                                   vision_heads=2, ip_dim=4, **_TINY),
    # f32 composed-pipeline golden configs (tests/golden/pipeline_*.npz).
    "tiny-pipe": PipelineConfig(vision_hidden=1280, vision_layers=2,
                                vision_heads=16, compute_dtype="float32",
                                **_TINY),
    "tiny-pipe-ip": PipelineConfig(vision_hidden=1280, vision_layers=2,
                                   vision_heads=16, ip_dim=4,
                                   compute_dtype="float32", **_TINY),
    "tiny-test-deep": PipelineConfig(
        model_channels=32, channel_mult=(1, 1, 2, 2),
        attention_resolutions=(4, 2, 1), num_res_blocks=1,
        num_head_channels=16, context_dim=32, vae_channels=(32, 32),
        text_hidden=32, text_layers=1, text_heads=1, vocab_size=500,
        max_tokens=8, vision_hidden=32, vision_layers=1, vision_heads=1,
        image_size=32, patch_size=16, allow_hash_tokenizer=True),
}

# Published config.json keys of each component -> PipelineConfig fields
# (and the compute dtype, which the published files do not give: the port
# records it beside the U-Net's, so a converted f32 pipeline stays f32).
_CONFIG_KEYS = {
    "unet": {k: k for k in ("model_channels", "channel_mult",
                            "attention_resolutions", "num_res_blocks",
                            "num_head_channels", "context_dim", "ip_dim",
                            "ip_weight", "compute_dtype")},
    "vae": {"block_out_channels": "vae_channels"},
    "text_encoder": {"hidden_size": "text_hidden",
                     "num_hidden_layers": "text_layers",
                     "num_attention_heads": "text_heads",
                     "vocab_size": "vocab_size",
                     "max_position_embeddings": "max_tokens"},
    "image_encoder": {"hidden_size": "vision_hidden",
                      "num_hidden_layers": "vision_layers",
                      "num_attention_heads": "vision_heads",
                      "image_size": "image_size", "patch_size": "patch_size"},
}
_WEIGHT_FILES = {"unet": "diffusion_pytorch_model",
                 "vae": "diffusion_pytorch_model",
                 "text_encoder": "model", "image_encoder": "model"}
_BIN_FILES = {"diffusion_pytorch_model": "diffusion_pytorch_model.bin",
              "model": "pytorch_model.bin"}


def _has_safetensors() -> bool:
    try:
        import safetensors.torch  # noqa: F401
    except ImportError:
        return False
    return True


def _read_weights(folder: str, stem: str) -> Dict[str, torch.Tensor]:
    """A component's state dict: ``<stem>.safetensors`` where safetensors
    imports and the file exists, else the torch ``.bin``; f32, without
    transformers' ``position_ids`` buffers."""
    st = os.path.join(folder, stem + ".safetensors")
    if _has_safetensors() and os.path.exists(st):
        from safetensors.torch import load_file

        sd = load_file(st)
    else:
        sd = torch.load(os.path.join(folder, _BIN_FILES[stem]),
                        map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()
            if not k.endswith("position_ids")}


class MVDreamPipeline:
    def __init__(self, config: PipelineConfig, device: str = "cuda",
                 tokenizer=None, scheduler: Optional[DDIMScheduler] = None):
        """The modules of ``config`` on ``device``, from PyTorch's default
        initialization under the current seed (``from_config`` seeds it;
        ``load_state_dicts`` or ``from_pretrained`` replaces them)."""
        c = self.cfg = config
        self.device = resolve_device(device)
        use_full_float32()
        self.scheduler = scheduler or DDIMScheduler()
        self.tokenizer = tokenizer or HashTokenizer(c.vocab_size,
                                                    c.max_tokens)
        cdt = (torch.bfloat16 if c.compute_dtype == "bfloat16"
               else torch.float32)
        with self.device:
            self.unet = MultiViewUNetModel(
                model_channels=c.model_channels, channel_mult=c.channel_mult,
                attention_resolutions=c.attention_resolutions,
                num_res_blocks=c.num_res_blocks,
                num_head_channels=c.num_head_channels,
                context_dim=c.context_dim, ip_dim=c.ip_dim,
                ip_weight=c.ip_weight, ip_embedding_dim=c.vision_hidden,
                dtype=cdt).eval()
            self.vae = AutoencoderKL(c.vae_channels, dtype=cdt).eval()
            self.text_encoder = CLIPTextModel(
                c.vocab_size, c.text_hidden, c.text_layers, c.text_heads,
                c.max_tokens).eval()
            self.image_encoder = (CLIPVisionModel(
                c.vision_hidden, c.vision_layers, c.vision_heads,
                c.image_size, c.patch_size).eval() if c.ip_dim else None)

    def modules(self) -> Dict[str, torch.nn.Module]:
        mods = {"unet": self.unet, "vae": self.vae,
                "text_encoder": self.text_encoder}
        if self.image_encoder is not None:
            mods["image_encoder"] = self.image_encoder
        return mods

    def load_state_dicts(self, sds) -> None:
        """Strict load of ``{component: state dict}`` (numpy arrays or
        tensors); components absent from ``sds`` keep their weights."""
        for name, module in self.modules().items():
            if name in sds:
                module.load_state_dict(
                    {k: torch.as_tensor(np.asarray(v, np.float32))
                     for k, v in sds[name].items()}, strict=True)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_config(cls, name: str = "mvdream", seed: int = 0,
                    device: str = "cuda", tokenizer=None):
        """Seeded random weights on ``device`` (the published checkpoints
        are not in the repository), with the U-Net's zeros where
        ``lgm_tpu``'s ``from_config`` has them."""
        dev = resolve_device(device)
        rng_devices = ([torch.cuda.current_device() if dev.index is None
                        else dev.index] if dev.type == "cuda" else [])
        with torch.random.fork_rng(devices=rng_devices):
            torch.manual_seed(seed)
            pipe = cls(CONFIGS[name], str(dev), tokenizer=tokenizer)
        init_like_lgm_tpu_(pipe.unet)
        return pipe

    @staticmethod
    def config_from_dir(path: str) -> PipelineConfig:
        """The PipelineConfig of a diffusers-layout directory, from each
        component's ``config.json`` (fields it does not give keep their
        defaults: bf16 compute where the U-Net's names no
        ``compute_dtype``, as published ones do not; no
        ``image_encoder/`` means no ip branch)."""
        fields: Dict = {}
        for comp, keys in _CONFIG_KEYS.items():
            p = os.path.join(path, comp, "config.json")
            if not os.path.exists(p):
                continue
            with open(p) as f:
                cfg = json.load(f)
            for src, dst in keys.items():
                if src in cfg:
                    v = cfg[src]
                    fields[dst] = tuple(v) if isinstance(v, list) else v
        if not os.path.isdir(os.path.join(path, "image_encoder")):
            fields["ip_dim"] = 0
        return PipelineConfig(**fields)

    @classmethod
    def from_pretrained(cls, path: Optional[str], device: str = "cuda"):
        """A pipeline from the published diffusers layout at ``path``."""
        if path is None:
            raise ValueError(
                "no checkpoint path given: the published diffusion weights "
                "cannot be downloaded here; pass a diffusers-layout "
                "directory, or use from_config() for random weights")
        config = cls.config_from_dir(path)
        tok = load_tokenizer(path, config.max_tokens)
        pipe = cls(config, device, tokenizer=tok)
        pipe.load_state_dicts({
            name: _read_weights(os.path.join(path, name), _WEIGHT_FILES[name])
            for name in pipe.modules()})
        return pipe

    def save_pretrained(self, path: str,
                        state_dicts: Optional[Dict[str, Dict]] = None
                        ) -> None:
        """Write the diffusers layout that ``from_pretrained`` reads
        (``.safetensors`` where safetensors imports, else ``.bin``); a
        component named in ``state_dicts`` is written from the state dict
        given there instead of its module's (the finetune's EMA U-Net)."""
        c = dataclasses.asdict(self.cfg)
        for name, module in self.modules().items():
            folder = os.path.join(path, name)
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "config.json"), "w") as f:
                json.dump({src: c[dst] for src, dst in
                           _CONFIG_KEYS[name].items()}, f, indent=1)
            sd = (state_dicts or {}).get(name) or module.state_dict()
            sd = {k: v.detach().float().cpu().contiguous()
                  for k, v in sd.items()}
            stem = _WEIGHT_FILES[name]
            if _has_safetensors():
                from safetensors.torch import save_file

                save_file(sd, os.path.join(folder, stem + ".safetensors"))
            else:
                torch.save(sd, os.path.join(folder, _BIN_FILES[stem]))
        if isinstance(self.tokenizer, CLIPTokenizer):
            tok = os.path.join(path, "tokenizer")
            os.makedirs(tok, exist_ok=True)
            for name in ("vocab.json", "merges.txt", "tokenizer_config.json",
                         "special_tokens_map.json"):
                src = os.path.join(self.tokenizer.path, name)
                if os.path.exists(src):
                    shutil.copy(src, tok)

    # ------------------------------------------------------------------
    # Encoders
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, prompt: str, negative_prompt: str = ""):
        """(neg, pos) text embeddings, each f32 [1, L, context_dim] on the
        device (ref: pipeline_mvdream.py:187-337)."""
        if (isinstance(self.tokenizer, HashTokenizer)
                and not self.cfg.allow_hash_tokenizer):
            raise RuntimeError(
                "prompt encoding requested but no CLIP tokenizer is "
                "available: the checkpoint directory has no tokenizer/ "
                "with the CLIP BPE vocab, and the hashing stand-in would "
                "give garbage conditioning with real weights")
        return tuple(self.text_encoder(torch.as_tensor(
            self.tokenizer(text), device=self.device))
            for text in (negative_prompt, prompt))

    @torch.inference_mode()
    def encode_image(self, image: np.ndarray):
        """(zeros, CLIP vision penultimate features) for the ip branch,
        each f32 [1, tokens, vision_hidden] (ref: pipeline_mvdream.py:
        402-413). image: [H, W, 3] in [0, 1]."""
        s = self.cfg.image_size
        img = (resize(image, (s, s), "cubic") - CLIP_IMAGE_MEAN) \
            / CLIP_IMAGE_STD
        pixels = torch.as_tensor(img.transpose(2, 0, 1)[None],
                                 dtype=torch.float32, device=self.device)
        feats = self.image_encoder(pixels)
        return torch.zeros_like(feats), feats

    @torch.inference_mode()
    def encode_image_latents(self, image: np.ndarray, size: int = 256):
        """(zeros, the VAE posterior mean of the image x 0.18215), each f32
        [1, 4, size/f, size/f] (ref: pipeline_mvdream.py:415-429)."""
        img = 2.0 * resize(image, (size, size), "linear") - 1.0
        x = torch.as_tensor(img.transpose(2, 0, 1)[None],
                            dtype=torch.float32, device=self.device)
        lat = self.vae.encode(x)[0] * SCALING_FACTOR
        return torch.zeros_like(lat), lat

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [F, 4, h, w] on the device -> images [F, 3, H, W] in
        [0, 1], f32."""
        img = self.vae.decode(latents.float() / SCALING_FACTOR).float()
        return (img / 2 + 0.5).clamp(0.0, 1.0)

    def decode_latents(self, latents) -> np.ndarray:
        """NHWC latents [F, h, w, 4] -> images [F, H, W, 3] in [0, 1]."""
        lat = torch.as_tensor(np.asarray(latents, np.float32),
                              device=self.device).permute(0, 3, 1, 2)
        return self.decode(lat).permute(0, 2, 3, 1).cpu().numpy()

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def denoise(self, latents: torch.Tensor, ctx: torch.Tensor,
                cam: torch.Tensor, num_inference_steps: int,
                guidance_scale: float, num_frames: int, ip=None,
                ip_img=None) -> torch.Tensor:
        """The DDIM loop (deterministic, eta 0) from latents [F, 4, h, w]
        f32: one U-Net call a step on the CFG pair (uncond first) when
        ``guidance_scale`` > 1, then the epsilon update."""
        sch = self.scheduler
        sch.set_timesteps(num_inference_steps)
        steps, a_t, a_prev = (torch.as_tensor(a, device=self.device)
                              for a in sch.step_arrays())
        ts = steps.float()
        cfg_on = guidance_scale > 1.0
        mult = 2 if cfg_on else 1
        if sch.prediction_type != "epsilon":
            raise ValueError(sch.prediction_type)
        lat = latents
        for i in range(len(ts)):
            lmi = torch.cat([lat] * mult) if cfg_on else lat
            tvec = ts[i].expand(num_frames * mult)
            eps = self.unet(lmi, tvec, ctx, num_frames, camera=cam, ip=ip,
                            ip_img=ip_img)
            if cfg_on:
                uncond, cond = eps[:num_frames], eps[num_frames:]
                eps = uncond + guidance_scale * (cond - uncond)
            at, ap = a_t[i], a_prev[i]
            x0 = (lat - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
            lat = torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * eps
        return lat

    def __call__(self, prompt: str = "", image: Optional[np.ndarray] = None,
                 height: int = 256, width: int = 256, elevation: float = 0.0,
                 num_inference_steps: int = 50, guidance_scale: float = 7.0,
                 negative_prompt: str = "", num_frames: int = 4,
                 seed: int = 0, output_type: str = "numpy", latents=None) -> np.ndarray:
        """Text- or image-conditioned multi-view generation (ref:
        pipeline_mvdream.py:431-558): images [F, H, W, 3] in [0, 1] (F
        includes the ip frame on the image path), or with
        ``output_type="latent"`` the final latents [F, H/f, W/f, 4].

        ``latents``: the initial noise [F, H/f, W/f, 4] (NHWC, as
        ``lgm_tpu``); without it, ``torch.randn`` from a generator seeded
        with ``seed``."""
        dev = self.device
        cfg_on = guidance_scale > 1.0
        use_ip = self.cfg.ip_dim > 0 and image is not None
        if use_ip and not cfg_on:
            raise ValueError("the image path runs with guidance_scale > 1")
        F = num_frames + 1 if use_ip else num_frames

        neg, pos = self.encode_prompt(prompt, negative_prompt)
        ctx = torch.cat([neg] * F + [pos] * F) if cfg_on else \
            torch.cat([pos] * F)
        cam = torch.as_tensor(get_camera(num_frames, elevation=elevation,
                                         extra_view=use_ip), device=dev)
        cam = torch.cat([cam] * (2 if cfg_on else 1))
        ip = ip_img = None
        if use_ip:
            ip_neg, ip_pos = self.encode_image(image)
            lat_neg, lat_pos = self.encode_image_latents(image, size=height)
            ip = torch.cat([ip_neg] * F + [ip_pos] * F)
            ip_img = torch.cat([lat_neg, lat_pos])

        f = 2 ** (len(self.cfg.vae_channels) - 1)
        shape = (F, 4, height // f, width // f)
        if latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            lat0 = torch.randn(shape, generator=gen, device=dev) \
                * self.scheduler.init_noise_sigma
        else:
            lat0 = torch.as_tensor(np.asarray(latents, np.float32),
                                   device=dev).permute(0, 3, 1, 2)
            if tuple(lat0.shape) != shape:
                raise ValueError(f"latents {tuple(latents.shape)}, expected "
                                 f"NHWC {(F, shape[2], shape[3], 4)}")
        lat = self.denoise(lat0.contiguous(), ctx, cam, num_inference_steps,
                           guidance_scale, F, ip, ip_img)
        if output_type == "latent":
            return lat.permute(0, 2, 3, 1).cpu().numpy()
        return self.decode(lat).permute(0, 2, 3, 1).cpu().numpy()

