"""Asymmetric multi-view U-Net in PyTorch (NCHW, bf16 compute, f32 params).

Port of ``lgm_tpu/models/unet.py`` (itself a re-design of the reference
torch U-Net, ref: core/unet.py:11-319). Module and parameter names follow
the reference torch state dict (``down_blocks.{i}.nets.{j}.conv1``,
``….attns.{j}.attn.qkv``, ``….downsample``, ``up_blocks.{i}.upsample``,
``norm_out``, ``conv_out``), so reference checkpoints and the golden
fixtures load with ``load_state_dict`` as they are.

Numerics mirror the JAX module's cast points: parameters are stored in
f32 and cast to the compute ``dtype`` at use (Flax's ``dtype`` /
``param_dtype`` split); GroupNorm(32, eps 1e-5) runs in f32; every
residual join is scaled by ``skip_scale`` and cast to ``dtype``;
``conv_out`` runs in f32. Traps kept: the stride-2 downsample is
``Conv2d(padding=1)`` (torch's symmetric pad, ROADMAP C3); upsampling is
nearest x2 then a 3x3 conv; the skip list is consumed deepest-first;
qkv has no bias and proj has one; MVAttention attends over the V views
passed in, not a hard-coded 4.

Training: gradients reach the f32 parameters through the casts to the
compute dtype; attention goes through ``attention``, the counterpart of
``lgm_tpu``'s ``_attention`` gate: ``mha`` (kernels K1 and K1ᵇ on the
card, in bf16 or, under ``mixed_precision="fp32"``, in exact f32) where
K1 takes the input, dense plain PyTorch elsewhere (the ``nano`` preset's
head dim of 6). ``remat=True`` recomputes each down/mid/up block in the backward
(``torch.utils.checkpoint``), the counterpart of ``unet_remat``
(``lgm_tpu/models/unet.py``): it changes memory, never the numbers.

View sharding (lgm_tpu's ``constrain_views``): given a vp ``group``, the
U-Net runs on the rank's own V/vp views of each scene; every layer but
the cross-view attention works view by view, and ``MVAttention`` gathers
the keys and values of all the group's views (rank order, the
one-process token order) for its own queries. The numbers are the
one-process numbers; each rank holds only its views' activations.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from lgm_tpu_torch.ops.mha import kernel_takes, mha, mha_views
from lgm_tpu_torch.parallel import dist


def use_full_float32() -> None:
    """Run f32 convolutions and matmuls in full f32 on the card.

    PyTorch's defaults differ by op: cuDNN convolutions may use TF32
    (``cudnn.allow_tf32`` is True) while matmuls do not. TF32 keeps ~3
    decimal digits; the f32 parts of this model (``conv_out``, the final
    1x1 conv, the whole net when ``mixed_precision="fp32"``) are held to
    the f32 JAX reference, so both are turned off. The bf16 convs of the
    main path are unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _gn(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm in f32, whatever the activation dtype."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias,
                        norm.eps)


def _conv(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype),
                    m.stride, m.padding)


def _linear(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    bias = None if m.bias is None else m.bias.to(dtype)
    return F.linear(x.to(dtype), m.weight.to(dtype), bias)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = False) -> torch.Tensor:
    """Exact softmax attention over [..., S, D] in plain PyTorch, the
    counterpart of ``jax.nn.dot_product_attention``'s XLA path: logits
    q·kᵀ in f32, scaled; softmax in f32; the probabilities cast to the
    input dtype; P·V in it. ``causal`` masks each query's later keys. Its
    gradient is autograd's."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = logits.shape[-2:]
        later = torch.ones(n, m, dtype=torch.bool,
                           device=logits.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, group=None) -> torch.Tensor:
    """Self-attention over [BH, S, D]: ``mha`` (K1, and K1ᵇ in the
    backward) where the kernels take this dtype and shape (``kernel_takes``:
    bf16 or f32, D in (32, 64), S % 128 == 0, scale > 0; at f32 the
    kernels are exact f32 softmax attention, so fp32 keeps O(S) memory
    where dense holds the [BH, S, S] logits), else
    ``dense_attention``, as ``lgm_tpu/models/unet.py::_attention`` keeps
    its kernel behind a gate and runs ``jax.nn.dot_product_attention``
    elsewhere. The choice reads dtype and shape only, never the device, so
    the CPU takes the card's route.

    With a vp ``group``, q, k and v hold this rank's S/vp tokens and the
    queries attend to the keys and values of the whole group: ``mha_views``
    (K1 and K1ᵇ at Sq = S/vp, Sk = S) where the kernels take that, else
    ``dense_attention`` over k and v joined by ``dist.gather_views``."""
    Sq, D = q.shape[-2:]
    Sk = Sq * dist.group_size(group)
    if kernel_takes(q.dtype, Sq, Sk, D, scale):
        if group is None:
            return mha(q, k, v, scale)
        return mha_views(q, k, v, scale, group)
    if group is not None:
        kv = dist.gather_views(torch.stack((k, v)), 2, group)
        k, v = kv[0], kv[1]
    return dense_attention(q, k, v, scale)


class _Attention(nn.Module):
    """Holds the reference's ``attn.qkv`` / ``attn.proj`` parameters."""

    def __init__(self, channels: int):
        super().__init__()
        self.qkv = nn.Linear(channels, 3 * channels, bias=False)
        self.proj = nn.Linear(channels, channels, bias=True)


class MVAttention(nn.Module):
    """Cross-view self-attention: [B*V, C, H, W] -> attention over all
    V*H*W tokens of a scene (ref: core/unet.py:11-49), through
    ``attention`` (kernels K1 and K1ᵇ on the card where they take the
    input). With a vp ``group``, x holds this rank's V views of each scene
    and the tokens of the group's views are the scene's."""

    def __init__(self, channels: int, num_heads: int = 16,
                 skip_scale: float = 1.0, dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.skip_scale = skip_scale
        self.dtype = dtype
        self.norm = nn.GroupNorm(32, channels, eps=1e-5)
        self.attn = _Attention(channels)

    def forward(self, x: torch.Tensor, num_views: int,
                group=None) -> torch.Tensor:
        BV, C, H, W = x.shape
        B, S, nh = BV // num_views, num_views * H * W, self.num_heads
        hd = C // nh
        h = _gn(self.norm, x).to(self.dtype)
        # Token order (view, row, col), as the NHWC reshape in JAX.
        h = h.permute(0, 2, 3, 1).reshape(B, S, C)
        qkv = _linear(self.attn.qkv, h, self.dtype)

        def heads(t):
            return t.reshape(B, S, nh, hd).transpose(1, 2).reshape(
                B * nh, S, hd).contiguous()

        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        o = attention(q, k, v, hd ** -0.5, group)
        o = o.reshape(B, nh, S, hd).transpose(1, 2).reshape(B, S, C)
        o = _linear(self.attn.proj, o, self.dtype)
        o = o.reshape(BV, H, W, C).permute(0, 3, 1, 2)
        return ((o + x) * self.skip_scale).to(self.dtype)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv3 -> GN -> SiLU -> conv3 (+1x1 shortcut), scaled
    residual join (ref: core/unet.py:51-103)."""

    def __init__(self, in_channels: int, out_channels: int,
                 skip_scale: float = 1.0, dtype=torch.bfloat16):
        super().__init__()
        self.skip_scale = skip_scale
        self.dtype = dtype
        self.norm1 = nn.GroupNorm(32, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = _conv(self.conv1, F.silu(_gn(self.norm1, x).to(dt)), dt)
        h = _conv(self.conv2, F.silu(_gn(self.norm2, h).to(dt)), dt)
        res = x if self.shortcut is None else _conv(self.shortcut, x, dt)
        return ((h + res) * self.skip_scale).to(dt)


class DownBlock(nn.Module):
    """num_layers x (resnet [+ mv-attention]) then a stride-2 conv
    (ref: core/unet.py:106-146). Returns (x, per-layer skips)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, downsample: bool = True,
                 attention: bool = False, skip_scale: float = 1.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.nets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels,
                        out_channels, skip_scale, dtype)
            for j in range(num_layers))
        self.attns = (nn.ModuleList(
            MVAttention(out_channels, 16, skip_scale, dtype)
            for _ in range(num_layers)) if attention else None)
        self.downsample = (nn.Conv2d(out_channels, out_channels, 3, stride=2,
                                     padding=1) if downsample else None)

    def forward(self, x, num_views: int, group=None):
        skips = []
        for j, net in enumerate(self.nets):
            x = net(x)
            if self.attns is not None:
                x = self.attns[j](x, num_views, group)
            skips.append(x)
        if self.downsample is not None:
            x = _conv(self.downsample, x, self.dtype)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    """resnet, then num_layers x ([mv-attention +] resnet)
    (ref: core/unet.py:149-185)."""

    def __init__(self, channels: int, num_layers: int = 1,
                 attention: bool = True, skip_scale: float = 1.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.nets = nn.ModuleList(
            ResnetBlock(channels, channels, skip_scale, dtype)
            for _ in range(num_layers + 1))
        self.attns = (nn.ModuleList(
            MVAttention(channels, 16, skip_scale, dtype)
            for _ in range(num_layers)) if attention else None)

    def forward(self, x, num_views: int, group=None):
        x = self.nets[0](x)
        for j, net in enumerate(self.nets[1:]):
            if self.attns is not None:
                x = self.attns[j](x, num_views, group)
            x = net(x)
        return x


class UpBlock(nn.Module):
    """num_layers x (concat skip + resnet [+ mv-attention]) then nearest-2x
    upsample + conv (ref: core/unet.py:188-231). ``skip_channels`` lists
    the channels of the skips in the order they are consumed."""

    def __init__(self, in_channels: int, skip_channels: Sequence[int],
                 out_channels: int, upsample: bool = True,
                 attention: bool = False, skip_scale: float = 1.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.nets = nn.ModuleList(
            ResnetBlock((in_channels if j == 0 else out_channels) + cs,
                        out_channels, skip_scale, dtype)
            for j, cs in enumerate(skip_channels))
        self.attns = (nn.ModuleList(
            MVAttention(out_channels, 16, skip_scale, dtype)
            for _ in skip_channels) if attention else None)
        self.upsample = (nn.Conv2d(out_channels, out_channels, 3, padding=1)
                         if upsample else None)

    def forward(self, x, skips: List[torch.Tensor], num_views: int,
                group=None):
        skips = list(skips)
        for j, net in enumerate(self.nets):
            x = net(torch.cat([x, skips.pop()], dim=1))  # deepest first
            if self.attns is not None:
                x = self.attns[j](x, num_views, group)
        if self.upsample is not None:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = _conv(self.upsample, x, self.dtype)
        return x


class UNet(nn.Module):
    """Asymmetric encoder/decoder U-Net over [B*V, Cin, H, W]
    (ref: core/unet.py:234-319)."""

    def __init__(self, in_channels: int = 9, out_channels: int = 14,
                 down_channels=(64, 128, 256, 512, 1024, 1024),
                 down_attention=(False, False, False, True, True, True),
                 mid_attention: bool = True,
                 up_channels=(1024, 1024, 512, 256),
                 up_attention=(True, True, True, False),
                 layers_per_block: int = 2,
                 skip_scale: float = math.sqrt(0.5),
                 dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.conv_in = nn.Conv2d(in_channels, down_channels[0], 3, padding=1)
        # Channels of the skip stack, built as forward() builds the tensors.
        stack = [down_channels[0]]
        blocks, cin = [], down_channels[0]
        for i, ch in enumerate(down_channels):
            last = i == len(down_channels) - 1
            blocks.append(DownBlock(cin, ch, layers_per_block, not last,
                                    down_attention[i], skip_scale, dtype))
            stack += [ch] * (layers_per_block + (0 if last else 1))
            cin = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock(down_channels[-1], 1, mid_attention,
                                  skip_scale, dtype)
        blocks = []
        for i, ch in enumerate(up_channels):
            n = layers_per_block + 1
            skips, stack = stack[-n:], stack[:-n]
            blocks.append(UpBlock(cin, skips[::-1], ch,
                                  i != len(up_channels) - 1, up_attention[i],
                                  skip_scale, dtype))
            cin = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = nn.GroupNorm(32, up_channels[-1], eps=1e-5)
        self.conv_out = nn.Conv2d(up_channels[-1], out_channels, 3, padding=1)

    def _block(self, blk, *args):
        """Run one block, recomputed in the backward under ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def forward(self, x: torch.Tensor, num_views: int,
                group=None) -> torch.Tensor:
        """x [B*V, Cin, H, W] -> [B*V, Cout, H, W]; with a vp ``group``,
        V is this rank's views of each scene (see the module note)."""
        x = _conv(self.conv_in, x, self.dtype)
        xss = [x]
        for blk in self.down_blocks:
            x, skips = self._block(blk, x, num_views, group)
            xss.extend(skips)
        x = self._block(self.mid_block, x, num_views, group)
        for blk in self.up_blocks:
            n = len(blk.nets)
            skips, xss = xss[-n:], xss[:-n]
            x = self._block(blk, x, skips, num_views, group)
        x = F.silu(_gn(self.norm_out, x).to(self.dtype))
        return _conv(self.conv_out, x, torch.float32)
