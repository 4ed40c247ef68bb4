"""Plain LGM: the asymmetric multi-view U-Net, the splatter head and the
Gaussian activations, as a function of a dict of f32 weights.

A frozen copy of LGM's model (core/unet.py, core/models.py) as the port
names its weights: GroupNorm(32, eps 1e-5), SiLU, 3x3 convolutions, the
residual joins scaled by sqrt(0.5), the cross-view self-attention over all
V·H·W tokens of a scene (16 heads, qkv without bias, proj with one, full
softmax in f32), stride-2 downsampling convolutions, nearest x2
upsampling then a 3x3 convolution, skips consumed deepest first, then a
1x1 convolution to the 14 Gaussian channels and the activations. The
rotation's normalisation runs across the Gaussians of a scene (``dim=-2``
on [B, N, 4]), as the reference's ``F.normalize`` with its default dim
does. Every product is f32 unless ``q`` rounds its operands (the control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import full

SKIP = math.sqrt(0.5)
HEADS = 16
LAYERS = 2


def blocks(cfg: dict) -> List[Tuple]:
    """The U-Net's layers in the order they run: ("res", name, cin, cout),
    ("attn", name, c), ("down", name, c), ("up", name, c), ("skip",),
    ("pop", n) and ("mark", level) entries."""
    down, up = cfg["down_channels"], cfg["up_channels"]
    plan, stack, cin = [], [down[0]], down[0]
    for i, ch in enumerate(down):
        last = i == len(down) - 1
        for j in range(LAYERS):
            plan.append(("res", f"down_blocks.{i}.nets.{j}",
                         cin if j == 0 else ch, ch))
            if cfg["down_attention"][i]:
                plan.append(("attn", f"down_blocks.{i}.attns.{j}", ch))
            plan.append(("skip",))
        if not last:
            plan.append(("down", f"down_blocks.{i}.downsample", ch))
            plan.append(("skip",))
        stack += [ch] * (LAYERS + (0 if last else 1))
        cin = ch
    plan.append(("res", "mid_block.nets.0", cin, cin))
    if cfg["mid_attention"]:
        plan.append(("attn", "mid_block.attns.0", cin))
    plan.append(("res", "mid_block.nets.1", cin, cin))
    for i, ch in enumerate(up):
        n = LAYERS + 1
        skips, stack = stack[-n:], stack[:-n]
        for j, cs in enumerate(skips[::-1]):
            plan.append(("res_skip", f"up_blocks.{i}.nets.{j}",
                         (cin if j == 0 else ch) + cs, ch))
            if cfg["up_attention"][i]:
                plan.append(("attn", f"up_blocks.{i}.attns.{j}", ch))
        if i != len(up) - 1:
            plan.append(("up", f"up_blocks.{i}.upsample", ch))
        cin = ch
    return plan


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every LGM weight, under the port's names."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    def norm(name, c):
        shapes[f"{name}.weight"] = (c,)
        shapes[f"{name}.bias"] = (c,)

    d0 = cfg["down_channels"][0]
    conv("unet.conv_in", 9, d0, 3)
    for entry in blocks(cfg):
        kind, name = entry[0], "unet." + entry[1] if len(entry) > 1 else ""
        if kind in ("res", "res_skip"):
            cin, cout = entry[2], entry[3]
            norm(f"{name}.norm1", cin)
            conv(f"{name}.conv1", cin, cout, 3)
            norm(f"{name}.norm2", cout)
            conv(f"{name}.conv2", cout, cout, 3)
            if cin != cout:
                conv(f"{name}.shortcut", cin, cout, 1)
        elif kind == "attn":
            c = entry[2]
            norm(f"{name}.norm", c)
            shapes[f"{name}.attn.qkv.weight"] = (3 * c, c)
            shapes[f"{name}.attn.proj.weight"] = (c, c)
            shapes[f"{name}.attn.proj.bias"] = (c,)
        elif kind in ("down", "up"):
            conv(name, entry[2], entry[2], 3)
    c = cfg["up_channels"][-1]
    norm("unet.norm_out", c)
    conv("unet.conv_out", c, 14, 3)
    conv("conv", 14, 14, 1)
    return shapes


def _gn(p, name, x):
    return F.group_norm(x, 32, p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def _conv(p, name, x, q, stride=1):
    w = p[f"{name}.weight"]
    return F.conv2d(q(x), q(w), p[f"{name}.bias"], stride, w.shape[-1] // 2)


def attention(q, k, v, scale, cast):
    """Softmax attention over [..., S, D], f32 logits and softmax."""
    logits = torch.matmul(cast(q), cast(k).transpose(-1, -2)) * scale
    return torch.matmul(cast(torch.softmax(logits, dim=-1)), cast(v))


def _res(p, name, x, q):
    h = _conv(p, f"{name}.conv1", F.silu(_gn(p, f"{name}.norm1", x)), q)
    h = _conv(p, f"{name}.conv2", F.silu(_gn(p, f"{name}.norm2", h)), q)
    res = _conv(p, f"{name}.shortcut", x, q) if f"{name}.shortcut.weight" \
        in p else x
    return (h + res) * SKIP


def _attn(p, name, x, views, q):
    BV, C, H, W = x.shape
    B, S, hd = BV // views, views * H * W, C // HEADS
    h = _gn(p, f"{name}.norm", x).permute(0, 2, 3, 1).reshape(B, S, C)
    qkv = F.linear(q(h), q(p[f"{name}.attn.qkv.weight"]))

    def heads(t):
        return t.reshape(B, S, HEADS, hd).transpose(1, 2)

    qh, kh, vh = (heads(t) for t in qkv.chunk(3, dim=-1))
    o = attention(qh, kh, vh, hd ** -0.5, q)
    o = o.transpose(1, 2).reshape(B, S, C)
    o = F.linear(q(o), q(p[f"{name}.attn.proj.weight"]),
                 p[f"{name}.attn.proj.bias"])
    return (o.reshape(BV, H, W, C).permute(0, 3, 1, 2) + x) * SKIP


def unet(p: dict, x: torch.Tensor, views: int, cfg: dict,
         q: Callable = full) -> torch.Tensor:
    """[B*V, 9, H, W] -> [B*V, 14, H/2, W/2] (at the big preset)."""
    x = _conv(p, "unet.conv_in", x, q)
    xss = [x]
    for entry in blocks(cfg):
        kind = entry[0]
        name = "unet." + entry[1] if len(entry) > 1 else ""
        if kind == "res":
            x = _res(p, name, x, q)
        elif kind == "res_skip":
            x = _res(p, name, torch.cat([x, xss.pop()], dim=1), q)
        elif kind == "attn":
            x = _attn(p, name, x, views, q)
        elif kind == "skip":
            xss.append(x)
        elif kind == "down":
            x = _conv(p, name, x, q, stride=2)
        elif kind == "up":
            x = _conv(p, name, F.interpolate(x, scale_factor=2,
                                              mode="nearest"), q)
    x = F.silu(_gn(p, "unet.norm_out", x))
    return _conv(p, "unet.conv_out", x, full)


def activate(x: torch.Tensor) -> torch.Tensor:
    """Raw [B, N, 14] -> Gaussians: pos clamp(-1, 1), opacity sigmoid,
    scale 0.1 softplus, rotation normalised across the N Gaussians (LGM's
    ``F.normalize`` default dim 1), rgb 0.5 tanh + 0.5."""
    return torch.cat([
        x[..., 0:3].clamp(-1.0, 1.0), torch.sigmoid(x[..., 3:4]),
        0.1 * F.softplus(x[..., 4:7]),
        F.normalize(x[..., 7:11], p=2.0, dim=-2, eps=1e-12),
        0.5 * torch.tanh(x[..., 11:14]) + 0.5], dim=-1)


def gaussians(p: dict, images: torch.Tensor, cfg: dict,
              q: Callable = full) -> torch.Tensor:
    """Network input [B, V, H, W, 9] -> Gaussians [B, V * splat^2, 14]."""
    B, V, H, W, C = images.shape
    x = images.reshape(B * V, H, W, C).permute(0, 3, 1, 2)
    x = unet(p, x, V, cfg, q)
    x = F.conv2d(x, p["conv.weight"], p["conv.bias"])
    s = cfg["splat_size"]
    return activate(x.permute(0, 2, 3, 1).reshape(B, V * s * s, 14))
