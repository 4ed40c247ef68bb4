"""Plain ImageDream, one image to four views, in PyTorch and f32.

ImageDream (Wang & Shi, arXiv:2312.02201) as LGM's ``mvdream/`` code runs
it: the CLIP text tower (the last state, after the final LayerNorm) and
the CLIP vision tower (the penultimate layer's state, no
``post_layernorm``); the Perceiver Resampler over the image features; the
multi-view latent U-Net (timestep and camera embeddings, self-attention
over the tokens of all frames together, the text cross-attention plus
``ip_weight`` times the cross-attention over the Resampler's tokens, the
image latent in the last frame of each CFG branch); the Stable Diffusion
VAE (the encoder's posterior mean x 0.18215, the decoder); the
deterministic DDIM loop with classifier-free guidance, uncond first; and
the host steps of LGM's ``infer.py``: recentre on the alpha, composite
over white, resize, and the views in the order [1, 2, 3, 0].

Every function takes a dict of f32 weights under the names of the
published diffusers layout (MVDream's ``unet/``, diffusers' ``vae/``,
transformers' ``text_encoder/`` and ``image_encoder/``), so that one
state dict loads into this and into a module tree of the same names.
Products are full f32 (TF32 off: ``exact``) unless ``q`` rounds their
operands, the control one step below a stated precision (``fp8``,
``bf16``). Imports torch, numpy and the standard library only.

Departures from the paper and from LGM's ``mvdream/`` code, each as the
program under test runs it:

- the CLIP towers use ``quick_gelu`` (x sigmoid(1.702 x)), not the exact
  GELU of the published OpenCLIP ViT-H configurations;
- the U-Net's transformer LayerNorms and the Resampler's use eps 1e-6,
  not PyTorch's 1e-5; GEGLU's gate and the Resampler's GELU are the tanh
  approximation, not the exact GELU;
- the image latent is the VAE posterior's mean, not a sample of it;
- the CLIP image input is the float image resized (cubic) to the tower's
  size and normalised, not ``CLIPImageProcessor``'s uint8 round trip,
  shortest-side resize and centre crop;
- every resize follows OpenCV's rules for float images (``cv2.resize``:
  linear and cubic with source coordinate (d + 0.5) s - 0.5 and the edge
  replicated, cubic with Keys' A = -0.75; area as the covered share of
  each source cell when shrinking and OpenCV's own linear form when
  growing); the latent's input is resized (linear) before the 2x - 1;
- the initial noise is an argument, not drawn here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SCALING_FACTOR = 0.18215
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
E4M3_MAX = 448.0
VIEW_ORDER = (1, 2, 3, 0)

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------

def exact() -> None:
    """Full f32 products on the card: TF32 is a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def full(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at one scale a tensor, back in f32."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def linear(p: Params, name: str, x, q: Callable = full):
    return F.linear(q(x), q(p[f"{name}.weight"]), p.get(f"{name}.bias"))


def conv(p: Params, name: str, x, q: Callable = full, stride: int = 1,
         padding: int = 1):
    return F.conv2d(q(x), q(p[f"{name}.weight"]), p.get(f"{name}.bias"),
                    stride, padding)


def group_norm(p: Params, name: str, x, eps: float):
    return F.group_norm(x, 32, p[f"{name}.weight"], p[f"{name}.bias"], eps)


def layer_norm(p: Params, name: str, x, eps: float):
    w = p[f"{name}.weight"]
    return F.layer_norm(x, w.shape, w, p[f"{name}.bias"], eps)


def attention(qh, kh, vh, q: Callable = full, causal: bool = False):
    """softmax(Q Kᵀ / sqrt(D)) V over [..., S, D]; logits and softmax in
    f32."""
    logits = torch.matmul(q(qh), q(kh).transpose(-1, -2)) \
        * qh.shape[-1] ** -0.5
    if causal:
        n = logits.shape[-1]
        later = torch.ones(n, n, dtype=torch.bool,
                           device=logits.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    return torch.matmul(q(torch.softmax(logits, dim=-1)), q(vh))


def multi_head(qx, kx, vx, heads: int, q: Callable = full,
               causal: bool = False):
    """[B, Nq, C] x [B, Nk, C] -> [B, Nq, C] over ``heads`` heads."""
    B, Nq, C = qx.shape

    def split(t):
        return t.reshape(B, t.shape[1], heads, C // heads).transpose(1, 2)

    o = attention(split(qx), split(kx), split(vx), q, causal)
    return o.transpose(1, 2).reshape(B, Nq, C)


# ---------------------------------------------------------------------------
# Weight names and shapes
# ---------------------------------------------------------------------------

class _Shapes:
    def __init__(self):
        self.out: Dict[str, Tuple[int, ...]] = {}

    def linear(self, name, cin, cout, bias=True):
        self.out[f"{name}.weight"] = (cout, cin)
        if bias:
            self.out[f"{name}.bias"] = (cout,)

    def conv(self, name, cin, cout, k, bias=True):
        self.out[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            self.out[f"{name}.bias"] = (cout,)

    def norm(self, name, c):
        self.out[f"{name}.weight"] = (c,)
        self.out[f"{name}.bias"] = (c,)


def _clip_layers(s: _Shapes, prefix: str, hidden: int, layers: int):
    for i in range(layers):
        n = f"{prefix}.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s.linear(f"{n}.self_attn.{proj}", hidden, hidden)
        s.norm(f"{n}.layer_norm1", hidden)
        s.linear(f"{n}.mlp.fc1", hidden, 4 * hidden)
        s.linear(f"{n}.mlp.fc2", 4 * hidden, hidden)
        s.norm(f"{n}.layer_norm2", hidden)


def text_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s, h = _Shapes(), cfg["text_hidden"]
    s.out["text_model.embeddings.token_embedding.weight"] = (
        cfg["vocab_size"], h)
    s.out["text_model.embeddings.position_embedding.weight"] = (
        cfg["max_tokens"], h)
    _clip_layers(s, "text_model", h, cfg["text_layers"])
    s.norm("text_model.final_layer_norm", h)
    return s.out


def vision_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s, h, ps = _Shapes(), cfg["vision_hidden"], cfg["patch_size"]
    s.out["vision_model.embeddings.class_embedding"] = (h,)
    s.conv("vision_model.embeddings.patch_embedding", 3, h, ps, bias=False)
    s.out["vision_model.embeddings.position_embedding.weight"] = (
        (cfg["image_size"] // ps) ** 2 + 1, h)
    s.norm("vision_model.pre_layrnorm", h)
    _clip_layers(s, "vision_model", h, cfg["vision_layers"])
    s.norm("vision_model.post_layernorm", h)
    return s.out


def unet_plan(cfg: dict) -> Tuple[List[list], int, List[list]]:
    """The U-Net's input blocks, the middle block's channels and the output
    blocks: each block a list of ("conv",), ("res", cin, cout), ("st",
    ch), ("down", ch) or ("up", ch) in the order they run."""
    mc = cfg["model_channels"]
    ins, chans, ch, ds = [[("conv",)]], [mc], mc, 1
    mults = cfg["channel_mult"]
    for level, mult in enumerate(mults):
        for _ in range(cfg["num_res_blocks"]):
            block = [("res", ch, mult * mc)]
            ch = mult * mc
            if ds in cfg["attention_resolutions"]:
                block.append(("st", ch))
            ins.append(block)
            chans.append(ch)
        if level != len(mults) - 1:
            ins.append([("down", ch)])
            chans.append(ch)
            ds *= 2
    outs, mid = [], ch
    for level in reversed(range(len(mults))):
        mult = mults[level]
        for i in range(cfg["num_res_blocks"] + 1):
            block = [("res", ch + chans.pop(), mult * mc)]
            ch = mult * mc
            if ds in cfg["attention_resolutions"]:
                block.append(("st", ch))
            if level and i == cfg["num_res_blocks"]:
                block.append(("up", ch))
                ds //= 2
            outs.append(block)
    return ins, mid, outs


def _res_shapes(s: _Shapes, n: str, cin: int, cout: int, ted: int):
    s.norm(f"{n}.in_layers.0", cin)
    s.conv(f"{n}.in_layers.2", cin, cout, 3)
    s.linear(f"{n}.emb_layers.1", ted, cout)
    s.norm(f"{n}.out_layers.0", cout)
    s.conv(f"{n}.out_layers.3", cout, cout, 3)
    if cin != cout:
        s.conv(f"{n}.skip_connection", cin, cout, 1)


def _st_shapes(s: _Shapes, n: str, ch: int, cfg: dict):
    ctx = cfg["context_dim"]
    s.norm(f"{n}.norm", ch)
    s.linear(f"{n}.proj_in", ch, ch)
    b = f"{n}.transformer_blocks.0"
    for k in ("to_q", "to_k", "to_v"):
        s.linear(f"{b}.attn1.{k}", ch, ch, bias=False)
    s.linear(f"{b}.attn1.to_out.0", ch, ch)
    s.linear(f"{b}.ff.net.0.proj", ch, 8 * ch)
    s.linear(f"{b}.ff.net.2", 4 * ch, ch)
    s.linear(f"{b}.attn2.to_q", ch, ch, bias=False)
    for k in ("to_k", "to_v") + (("to_k_ip", "to_v_ip")
                                  if cfg["ip_dim"] else ()):
        s.linear(f"{b}.attn2.{k}", ctx, ch, bias=False)
    s.linear(f"{b}.attn2.to_out.0", ch, ch)
    for k in ("norm1", "norm2", "norm3"):
        s.norm(f"{b}.{k}", ch)
    s.linear(f"{n}.proj_out", ch, ch)


RESAMPLER_DEPTH, RESAMPLER_HEADS, RESAMPLER_HEAD_DIM = 4, 12, 64


def unet_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s, mc = _Shapes(), cfg["model_channels"]
    ted, ctx = 4 * mc, cfg["context_dim"]
    s.linear("time_embed.0", mc, ted)
    s.linear("time_embed.2", ted, ted)
    s.linear("camera_embed.0", 16, ted)
    s.linear("camera_embed.2", ted, ted)
    if cfg["ip_dim"]:
        inner = RESAMPLER_HEADS * RESAMPLER_HEAD_DIM
        s.out["image_embed.latents"] = (1, cfg["ip_dim"], ctx)
        s.linear("image_embed.proj_in", cfg["vision_hidden"], ctx)
        s.linear("image_embed.proj_out", ctx, ctx)
        s.norm("image_embed.norm_out", ctx)
        for i in range(RESAMPLER_DEPTH):
            n = f"image_embed.layers.{i}"
            s.norm(f"{n}.0.norm1", ctx)
            s.norm(f"{n}.0.norm2", ctx)
            s.linear(f"{n}.0.to_q", ctx, inner, bias=False)
            s.linear(f"{n}.0.to_kv", ctx, 2 * inner, bias=False)
            s.linear(f"{n}.0.to_out", inner, ctx, bias=False)
            s.norm(f"{n}.1.0", ctx)
            s.linear(f"{n}.1.1", ctx, 4 * ctx, bias=False)
            s.linear(f"{n}.1.3", 4 * ctx, ctx, bias=False)
    ins, ch, outs = unet_plan(cfg)

    def blocks(prefix, plan):
        for i, block in enumerate(plan):
            for j, (kind, *a) in enumerate(block):
                n = f"{prefix}.{i}.{j}"
                if kind == "conv":
                    s.conv(n, 4, mc, 3)
                elif kind == "res":
                    _res_shapes(s, n, a[0], a[1], ted)
                elif kind == "st":
                    _st_shapes(s, n, a[0], cfg)
                elif kind == "down":
                    s.conv(f"{n}.op", a[0], a[0], 3)
                else:
                    s.conv(f"{n}.conv", a[0], a[0], 3)

    blocks("input_blocks", ins)
    _res_shapes(s, "middle_block.0", ch, ch, ted)
    _st_shapes(s, "middle_block.1", ch, cfg)
    _res_shapes(s, "middle_block.2", ch, ch, ted)
    blocks("output_blocks", outs)
    s.norm("out.0", mc)
    s.conv("out.2", mc, 4, 3)
    return s.out


def _vae_res_shapes(s: _Shapes, n: str, cin: int, cout: int):
    s.norm(f"{n}.norm1", cin)
    s.conv(f"{n}.conv1", cin, cout, 3)
    s.norm(f"{n}.norm2", cout)
    s.conv(f"{n}.conv2", cout, cout, 3)
    if cin != cout:
        s.conv(f"{n}.conv_shortcut", cin, cout, 1)


def _vae_mid_shapes(s: _Shapes, n: str, ch: int):
    _vae_res_shapes(s, f"{n}.resnets.0", ch, ch)
    a = f"{n}.attentions.0"
    s.norm(f"{a}.group_norm", ch)
    for k in ("to_q", "to_k", "to_v", "to_out.0"):
        s.linear(f"{a}.{k}", ch, ch)
    _vae_res_shapes(s, f"{n}.resnets.1", ch, ch)


VAE_LAYERS, LATENT = 2, 4


def vae_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    s, chans = _Shapes(), list(cfg["vae_channels"])
    s.conv("encoder.conv_in", 3, chans[0], 3)
    cin = chans[0]
    for i, ch in enumerate(chans):
        for j in range(VAE_LAYERS):
            _vae_res_shapes(s, f"encoder.down_blocks.{i}.resnets.{j}",
                            cin if j == 0 else ch, ch)
        if i != len(chans) - 1:
            s.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
        cin = ch
    _vae_mid_shapes(s, "encoder.mid_block", chans[-1])
    s.norm("encoder.conv_norm_out", chans[-1])
    s.conv("encoder.conv_out", chans[-1], 2 * LATENT, 3)
    rev = chans[::-1]
    s.conv("decoder.conv_in", LATENT, rev[0], 3)
    _vae_mid_shapes(s, "decoder.mid_block", rev[0])
    cin = rev[0]
    for i, ch in enumerate(rev):
        for j in range(VAE_LAYERS + 1):
            _vae_res_shapes(s, f"decoder.up_blocks.{i}.resnets.{j}",
                            cin if j == 0 else ch, ch)
        if i != len(rev) - 1:
            s.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
        cin = ch
    s.norm("decoder.conv_norm_out", rev[-1])
    s.conv("decoder.conv_out", rev[-1], 3, 3)
    s.conv("quant_conv", 2 * LATENT, 2 * LATENT, 1)
    s.conv("post_quant_conv", LATENT, LATENT, 1)
    return s.out


def param_shapes(cfg: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """{component: {name: shape}} of every weight, components as the
    diffusers layout names its folders."""
    out = {"unet": unet_shapes(cfg), "vae": vae_shapes(cfg),
           "text_encoder": text_shapes(cfg)}
    if cfg["ip_dim"]:
        out["image_encoder"] = vision_shapes(cfg)
    return out


def norm_scales(shapes: Dict[str, Tuple[int, ...]]) -> List[str]:
    """The names of the GroupNorm and LayerNorm scales among ``shapes``:
    the one-dimensional ``weight``s."""
    return [k for k, s in shapes.items()
            if k.endswith(".weight") and len(s) == 1]


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _clip_layer(p: Params, n: str, x, heads: int, causal: bool, q):
    h = layer_norm(p, f"{n}.layer_norm1", x, 1e-5)
    qx, kx, vx = (linear(p, f"{n}.self_attn.{k}_proj", h, q)
                  for k in "qkv")
    x = x + linear(p, f"{n}.self_attn.out_proj",
                   multi_head(qx, kx, vx, heads, q, causal), q)
    h = layer_norm(p, f"{n}.layer_norm2", x, 1e-5)
    return x + linear(p, f"{n}.mlp.fc2",
                      quick_gelu(linear(p, f"{n}.mlp.fc1", h, q)), q)


def text_tower(p: Params, ids: torch.Tensor, cfg: dict,
               q: Callable = full) -> torch.Tensor:
    """Token ids [B, L] -> the final LayerNorm's state [B, L, hidden]."""
    exact()
    e = "text_model.embeddings"
    x = (p[f"{e}.token_embedding.weight"][ids]
         + p[f"{e}.position_embedding.weight"][:ids.shape[1]][None])
    for i in range(cfg["text_layers"]):
        x = _clip_layer(p, f"text_model.encoder.layers.{i}", x,
                        cfg["text_heads"], True, q)
    return layer_norm(p, "text_model.final_layer_norm", x, 1e-5)


def vision_tower(p: Params, pixels: torch.Tensor, cfg: dict,
                 q: Callable = full) -> torch.Tensor:
    """Normalised pixels [B, 3, S, S] -> the penultimate layer's state
    [B, (S / patch)² + 1, hidden]."""
    exact()
    e = "vision_model.embeddings"
    ps = cfg["patch_size"]
    x = conv(p, f"{e}.patch_embedding", pixels, q, stride=ps, padding=0)
    x = x.flatten(2).transpose(1, 2)
    cls = p[f"{e}.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + p[f"{e}.position_embedding.weight"]
    x = layer_norm(p, "vision_model.pre_layrnorm", x, 1e-5)
    for i in range(cfg["vision_layers"] - 1):
        x = _clip_layer(p, f"vision_model.encoder.layers.{i}", x,
                        cfg["vision_heads"], False, q)
    return x


# ---------------------------------------------------------------------------
# The multi-view U-Net and its Resampler
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoids [N, dim], cosines first, periods up to 10,000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def resampler(p: Params, feats: torch.Tensor, q: Callable = full):
    """CLIP image features [B, L, vision_hidden] -> [B, ip_dim,
    context_dim]: learned latents that attend to (features ++ latents)."""
    x = linear(p, "image_embed.proj_in", feats, q)
    lat = p["image_embed.latents"].expand(x.shape[0], -1, -1)
    for i in range(RESAMPLER_DEPTH):
        n = f"image_embed.layers.{i}"
        xn = layer_norm(p, f"{n}.0.norm1", x, 1e-6)
        ln = layer_norm(p, f"{n}.0.norm2", lat, 1e-6)
        kv = linear(p, f"{n}.0.to_kv", torch.cat([xn, ln], dim=1), q)
        k, v = kv.chunk(2, dim=-1)
        o = multi_head(linear(p, f"{n}.0.to_q", ln, q), k, v,
                       RESAMPLER_HEADS, q)
        lat = lat + linear(p, f"{n}.0.to_out", o, q)
        h = layer_norm(p, f"{n}.1.0", lat, 1e-6)
        lat = lat + linear(p, f"{n}.1.3",
                           gelu_tanh(linear(p, f"{n}.1.1", h, q)), q)
    return layer_norm(p, "image_embed.norm_out",
                      linear(p, "image_embed.proj_out", lat, q), 1e-6)


def _res(p: Params, n: str, x, emb, q):
    h = conv(p, f"{n}.in_layers.2",
             F.silu(group_norm(p, f"{n}.in_layers.0", x, 1e-5)), q)
    h = h + linear(p, f"{n}.emb_layers.1", F.silu(emb), q)[:, :, None, None]
    h = F.silu(group_norm(p, f"{n}.out_layers.0", h, 1e-5))
    h = conv(p, f"{n}.out_layers.3", h, q)
    if f"{n}.skip_connection.weight" in p:
        x = conv(p, f"{n}.skip_connection", x, q, padding=0)
    return x + h


def _cross(p: Params, n: str, x, text, ip_tokens, heads, ip_weight, q):
    qx = linear(p, f"{n}.to_q", x, q)
    o = multi_head(qx, linear(p, f"{n}.to_k", text, q),
                   linear(p, f"{n}.to_v", text, q), heads, q)
    if ip_tokens is not None:
        o = o + ip_weight * multi_head(
            qx, linear(p, f"{n}.to_k_ip", ip_tokens, q),
            linear(p, f"{n}.to_v_ip", ip_tokens, q), heads, q)
    return linear(p, f"{n}.to_out.0", o, q)


def _st(p: Params, n: str, x, text, ip_tokens, frames, cfg, q):
    BF, C, H, W = x.shape
    heads = C // cfg["num_head_channels"]
    h = group_norm(p, f"{n}.norm", x, 1e-6)
    h = linear(p, f"{n}.proj_in", h.permute(0, 2, 3, 1).reshape(
        BF, H * W, C), q)
    b = f"{n}.transformer_blocks.0"
    # Self-attention over the tokens of all frames of a sample together.
    j = h.reshape(BF // frames, frames * H * W, C)
    jn = layer_norm(p, f"{b}.norm1", j, 1e-6)
    o = multi_head(*(linear(p, f"{b}.attn1.{k}", jn, q)
                     for k in ("to_q", "to_k", "to_v")), heads, q)
    h = (j + linear(p, f"{b}.attn1.to_out.0", o, q)).reshape(BF, H * W, C)
    h = h + _cross(p, f"{b}.attn2", layer_norm(p, f"{b}.norm2", h, 1e-6),
                   text, ip_tokens, heads, cfg["ip_weight"], q)
    a, gate = linear(p, f"{b}.ff.net.0.proj",
                     layer_norm(p, f"{b}.norm3", h, 1e-6), q).chunk(2, -1)
    h = h + linear(p, f"{b}.ff.net.2", a * gelu_tanh(gate), q)
    h = linear(p, f"{n}.proj_out", h, q)
    return h.reshape(BF, H, W, C).permute(0, 3, 1, 2) + x


def unet(p: Params, x, t, context, frames: int, camera, cfg: dict,
         ip=None, ip_img=None, q: Callable = full) -> torch.Tensor:
    """ε [(B F), 4, h, w] from latents [(B F), 4, h, w], timesteps
    [(B F)], text context [(B F), L, context_dim], cameras [(B F), 16],
    and on the image path CLIP image features ``ip`` [(B F), L_img,
    vision_hidden] and image latents ``ip_img`` [B, 4, h, w], which take
    the place of each sample's last frame."""
    exact()
    emb = linear(p, "time_embed.0",
                 timestep_embedding(t, cfg["model_channels"]), q)
    emb = linear(p, "time_embed.2", F.silu(emb), q)
    c = linear(p, "camera_embed.0", camera, q)
    emb = emb + linear(p, "camera_embed.2", F.silu(c), q)
    ip_tokens = None
    if cfg["ip_dim"]:
        x = x.reshape(-1, frames, *x.shape[1:]).clone()
        x[:, -1] = ip_img
        x = x.reshape(-1, *x.shape[2:])
        ip_tokens = resampler(p, ip, q)
    ins, _, outs = unet_plan(cfg)

    def run(prefix, i, block, h):
        for j, (kind, *_) in enumerate(block):
            n = f"{prefix}.{i}.{j}"
            if kind == "conv":
                h = conv(p, n, h, q)
            elif kind == "res":
                h = _res(p, n, h, emb, q)
            elif kind == "st":
                h = _st(p, n, h, context, ip_tokens, frames, cfg, q)
            elif kind == "down":
                h = conv(p, f"{n}.op", h, q, stride=2)
            else:
                h = conv(p, f"{n}.conv",
                         F.interpolate(h, scale_factor=2, mode="nearest"), q)
        return h

    skips, h = [], x
    for i, block in enumerate(ins):
        h = run("input_blocks", i, block, h)
        skips.append(h)
    h = _res(p, "middle_block.0", h, emb, q)
    h = _st(p, "middle_block.1", h, context, ip_tokens, frames, cfg, q)
    h = _res(p, "middle_block.2", h, emb, q)
    for i, block in enumerate(outs):
        h = run("output_blocks", i, block, torch.cat([h, skips.pop()], 1))
    h = F.silu(group_norm(p, "out.0", h, 1e-5))
    return conv(p, "out.2", h, full)


# ---------------------------------------------------------------------------
# The VAE
# ---------------------------------------------------------------------------

def _vae_res(p: Params, n: str, x, q):
    h = conv(p, f"{n}.conv1", F.silu(group_norm(p, f"{n}.norm1", x, 1e-6)),
             q)
    h = conv(p, f"{n}.conv2", F.silu(group_norm(p, f"{n}.norm2", h, 1e-6)),
             q)
    if f"{n}.conv_shortcut.weight" in p:
        x = conv(p, f"{n}.conv_shortcut", x, q, padding=0)
    return x + h


def _vae_mid(p: Params, n: str, x, q):
    x = _vae_res(p, f"{n}.resnets.0", x, q)
    B, C, H, W = x.shape
    a = f"{n}.attentions.0"
    h = group_norm(p, f"{a}.group_norm", x, 1e-6).flatten(2).transpose(1, 2)
    o = attention(*(linear(p, f"{a}.{k}", h, q)
                    for k in ("to_q", "to_k", "to_v")), q)
    o = linear(p, f"{a}.to_out.0", o, q)
    x = x + o.transpose(1, 2).reshape(B, C, H, W)
    return _vae_res(p, f"{n}.resnets.1", x, q)


def vae_encode(p: Params, x: torch.Tensor, cfg: dict,
               q: Callable = full) -> torch.Tensor:
    """Image [B, 3, H, W] in [-1, 1] -> the posterior's mean x 0.18215
    [B, 4, H/f, W/f]. Each stride-2 convolution pads one row and column
    after the image and none before."""
    exact()
    chans = cfg["vae_channels"]
    h = conv(p, "encoder.conv_in", x, q)
    for i in range(len(chans)):
        for j in range(VAE_LAYERS):
            h = _vae_res(p, f"encoder.down_blocks.{i}.resnets.{j}", h, q)
        if i != len(chans) - 1:
            h = conv(p, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), q, stride=2, padding=0)
    h = _vae_mid(p, "encoder.mid_block", h, q)
    h = F.silu(group_norm(p, "encoder.conv_norm_out", h, 1e-6))
    moments = conv(p, "quant_conv", conv(p, "encoder.conv_out", h, full),
                   full, padding=0)
    return moments[:, :LATENT] * SCALING_FACTOR


def vae_decode(p: Params, z: torch.Tensor, cfg: dict,
               q: Callable = full) -> torch.Tensor:
    """Latents [B, 4, h, w] (scaled by 0.18215) -> images [B, 3, H, W] in
    [0, 1]."""
    exact()
    chans = cfg["vae_channels"]
    h = conv(p, "post_quant_conv", z / SCALING_FACTOR, full, padding=0)
    h = conv(p, "decoder.conv_in", h, q)
    h = _vae_mid(p, "decoder.mid_block", h, q)
    for i in range(len(chans)):
        for j in range(VAE_LAYERS + 1):
            h = _vae_res(p, f"decoder.up_blocks.{i}.resnets.{j}", h, q)
        if i != len(chans) - 1:
            h = conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2, mode="nearest"), q)
    h = F.silu(group_norm(p, "decoder.conv_norm_out", h, 1e-6))
    img = conv(p, "decoder.conv_out", h, full)
    return (img / 2 + 0.5).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# DDIM and the cameras
# ---------------------------------------------------------------------------

def ddim_schedule(steps: int, train_steps: int = 1000):
    """[(t, alpha-bar at t, alpha-bar at the next t)] of the deterministic
    sampler: scaled-linear betas 0.00085..0.012, 'leading' timesteps with
    offset 1, the last step ending at alpha-bar of t = 0."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, train_steps,
                        dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas).astype(np.float32)
    gap = train_steps // steps
    out = []
    for i in reversed(range(steps)):
        t = i * gap + 1
        prev = t - gap
        out.append((t, float(abar[t]),
                    float(abar[prev] if prev >= 0 else abar[0])))
    return out


def orbit_pose(elevation: float, azimuth: float) -> np.ndarray:
    """OpenGL c2w pose on the unit sphere, looking at the origin (kiui's
    convention: y = -sin(elevation), azimuth 0 on +z)."""
    el, az = math.radians(elevation), math.radians(azimuth)
    pos = np.array([math.cos(el) * math.sin(az), -math.sin(el),
                    math.cos(el) * math.cos(az)])
    fwd = pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, up / np.linalg.norm(up), fwd], axis=1)
    pose[:3, 3] = pos
    return pose


def cameras(frames: int, elevation: float = 0.0) -> torch.Tensor:
    """[frames + 1, 16]: the views at azimuth 0, 360/frames, ... in
    Blender's axes (OpenGL's z negated, then y and z swapped), flattened,
    and a zero pose for the image's frame."""
    out = []
    for k in range(frames):
        pose = orbit_pose(elevation, k * 360.0 / frames)
        pose[2] *= -1
        pose[[1, 2]] = pose[[2, 1]]
        out.append(pose.reshape(16))
    out.append(np.zeros(16))
    return torch.tensor(np.stack(out), dtype=torch.float32)


def denoise(eps_fn: Callable, lat: torch.Tensor, steps: int,
            guidance: float) -> torch.Tensor:
    """The DDIM loop from latents [F, 4, h, w]: ``eps_fn(x, t)`` gives ε of
    the CFG pair x = (lat, lat) at timestep t, uncond first; guided ε =
    ε_u + guidance (ε_c - ε_u)."""
    frames = lat.shape[0]
    for t, a_t, a_prev in ddim_schedule(steps):
        eps = eps_fn(torch.cat([lat, lat]), t)
        eps = eps[:frames] + guidance * (eps[frames:] - eps[:frames])
        x0 = (lat - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
        lat = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
    return lat


def unet_inputs(text: torch.Tensor, feats: torch.Tensor,
                latent: torch.Tensor, frames: int,
                elevation: float = 0.0) -> dict:
    """The U-Net's conditioning of the CFG pair (uncond first) on the image
    path: ``text`` (neg, pos) [2, L, context_dim], the image's CLIP
    features [1, L_img, vision_hidden] (zeros for the uncond branch) and
    its latent [1, 4, h, w] (zeros for the uncond branch)."""
    dev = latent.device
    n = frames + 1
    return {"context": torch.cat([text[:1]] * n + [text[1:]] * n),
            "camera": cameras(frames, elevation).to(dev).repeat(2, 1),
            "ip": torch.cat([torch.zeros_like(feats)] * n + [feats] * n),
            "ip_img": torch.cat([torch.zeros_like(latent), latent])}


# ---------------------------------------------------------------------------
# Host steps
# ---------------------------------------------------------------------------

def _axis_weights(src: int, dst: int, mode: str) -> torch.Tensor:
    """[dst, src] weights of one axis of OpenCV's float resize: ``linear``,
    ``cubic``, ``area`` (shrinking) or ``area_grow``."""
    s = src / dst
    w = torch.zeros(dst, src, dtype=torch.float64)
    for d in range(dst):
        if mode == "area":
            lo, hi = d * s, (d + 1) * s
            for c in range(int(math.floor(lo)), min(int(math.ceil(hi)), src)):
                w[d, c] = (min(hi, c + 1) - max(lo, c)) / s
            continue
        if mode == "area_grow":
            c = math.floor(d * s)
            f = (d + 1) - (c + 1) / s
            f = 0.0 if f <= 0 else f - math.floor(f)
            taps = ((c, 1 - f), (c + 1, f))
        else:
            x = (d + 0.5) * s - 0.5
            c = math.floor(x)
            f = x - c
            if mode == "linear":
                taps = ((c, 1 - f), (c + 1, f))
            else:
                a = -0.75

                def keys(u):
                    u = abs(u)
                    if u <= 1:
                        return ((a + 2) * u - (a + 3)) * u * u + 1
                    return ((a * u - 5 * a) * u + 8 * a) * u - 4 * a
                taps = tuple((c + k, keys(f - k)) for k in (-1, 0, 1, 2))
        for c, v in taps:
            w[d, min(max(c, 0), src - 1)] += v
    return w


def resize(img: torch.Tensor, height: int, width: int,
           mode: str) -> torch.Tensor:
    """[H, W, C] float -> [height, width, C] by OpenCV's rules for float
    images: ``linear``, ``cubic`` or ``area``. For area, both axes take
    the shrinking form only when neither grows."""
    H, W = img.shape[:2]
    if mode == "area" and not (H >= height and W >= width):
        mode = "area_grow"
    wy, wx = _axis_weights(H, height, mode), _axis_weights(W, width, mode)
    x = img.double()
    x = torch.einsum("yh,hwc->ywc", wy.to(x.device), x)
    return torch.einsum("xw,ywc->yxc", wx.to(x.device), x).float()


def recentre(rgba: torch.Tensor, border: float = 0.2) -> torch.Tensor:
    """[H, W, 4] RGBA -> [S, S, 4], S = max(H, W): the box of alpha > 0
    scaled (area) so that its longer side is (1 - border) S, centred on a
    zero canvas."""
    H, W = rgba.shape[:2]
    size = max(H, W)
    out = torch.zeros(size, size, 4, dtype=rgba.dtype, device=rgba.device)
    ys, xs = torch.nonzero(rgba[..., 3] > 0, as_tuple=True)
    if ys.numel() == 0:
        out[:H, :W] = rgba
        return out
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    want = max(int(size * (1.0 - border)), 1)
    scale = want / max(y1 - y0, x1 - x0)
    nh, nw = max(int((y1 - y0) * scale), 1), max(int((x1 - x0) * scale), 1)
    oy, ox = (size - nh) // 2, (size - nw) // 2
    out[oy:oy + nh, ox:ox + nw] = resize(rgba[y0:y1, x0:x1], nh, nw, "area")
    return out


def image_rgb(bgra: torch.Tensor) -> torch.Tensor:
    """OpenCV's [H, W, 4] BGRA in [0, 1] -> the recentred image over white,
    [S, S, 3] RGB."""
    rgba = recentre(bgra[..., [2, 1, 0, 3]].float())
    return rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])


def clip_pixels(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """[S, S, 3] in [0, 1] -> the vision tower's input [1, 3, size, size]:
    cubic resize, CLIP's mean and std."""
    img = resize(rgb, size, size, "cubic")
    mean = torch.tensor(CLIP_MEAN, device=img.device)
    std = torch.tensor(CLIP_STD, device=img.device)
    return ((img - mean) / std).permute(2, 0, 1)[None]


def vae_pixels(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """[S, S, 3] in [0, 1] -> the encoder's input [1, 3, size, size] in
    [-1, 1] (linear resize)."""
    return (2.0 * resize(rgb, size, size, "linear") - 1.0).permute(
        2, 0, 1)[None]


def views_of(images: torch.Tensor, size: int) -> torch.Tensor:
    """Decoded frames [F, 3, H, W] -> LGM's views [4, size, size, 3]:
    frames 1, 2, 3, 0, each resized (linear)."""
    return torch.stack([resize(images[k].permute(1, 2, 0), size, size,
                               "linear") for k in VIEW_ORDER])


# ---------------------------------------------------------------------------
# One image to four views
# ---------------------------------------------------------------------------

def conditions(w: Dict[str, Params], bgra: torch.Tensor, ids: torch.Tensor,
               cfg: dict, size: int = 256, q_clip: Callable = full,
               q: Callable = full) -> dict:
    """The image's conditioning: ``text`` [2, L, context_dim] (the prompt's
    ids ``ids`` [1, L] as uncond and cond), CLIP image ``features`` [1,
    L_img, vision_hidden] and ``latent`` [1, 4, size/f, size/f], from the
    host image [H, W, 4] BGRA."""
    dev = ids.device
    rgb = image_rgb(bgra.to(dev))
    text = text_tower(w["text_encoder"], torch.cat([ids, ids]), cfg, q_clip)
    feats = vision_tower(w["image_encoder"],
                         clip_pixels(rgb, cfg["image_size"]), cfg, q_clip)
    latent = vae_encode(w["vae"], vae_pixels(rgb, size), cfg, q)
    return {"text": text, "features": feats, "latent": latent}


def image_to_views(w: Dict[str, Params], bgra: torch.Tensor,
                   ids: torch.Tensor, noise: torch.Tensor, cfg: dict,
                   out_size: int, steps: int = 30, guidance: float = 5.0,
                   elevation: float = 0.0, q_clip: Callable = full,
                   q: Callable = full) -> torch.Tensor:
    """One BGRA image [H, W, 4] in [0, 1] -> LGM's four views [4, out_size,
    out_size, 3]: the conditions, the DDIM loop from ``noise`` [5, 4, h,
    w] (four views and the image's frame) and the decoder. ``q_clip``
    rounds the CLIP towers' products, ``q`` the U-Net's and the VAE's."""
    frames = noise.shape[0] - 1
    f = 2 ** (len(cfg["vae_channels"]) - 1)
    c = conditions(w, bgra, ids, cfg, noise.shape[-1] * f, q_clip, q)
    kw = unet_inputs(c["text"], c["features"], c["latent"], frames,
                     elevation)

    def eps(x, t):
        tt = torch.full((x.shape[0],), float(t), device=x.device)
        return unet(w["unet"], x, tt, kw["context"], frames + 1,
                    kw["camera"], cfg, kw["ip"], kw["ip_img"], q)

    lat = denoise(eps, noise, steps, guidance)
    return views_of(vae_decode(w["vae"], lat, cfg, q), out_size)
