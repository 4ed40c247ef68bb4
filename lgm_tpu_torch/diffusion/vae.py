"""AutoencoderKL (the Stable Diffusion VAE) in PyTorch, NCHW.

Port of ``lgm_tpu/diffusion/vae.py`` (ref: mvdream/pipeline_mvdream.py:
29-37,339-345,425-429), under diffusers' state-dict names
(``encoder.down_blocks.{i}.resnets.{j}.conv1``, ``….downsamplers.0.conv``,
``mid_block.attentions.0.to_q``, ``quant_conv``, ...), so a published
``vae/`` and the ``vae_sd/`` goldens load with ``load_state_dict``.

Numerics mirror the JAX module's cast points: parameters in f32, cast to
the compute ``dtype`` at use; GroupNorm(32, eps 1e-6) in f32; the
encoder's ``conv_out`` and ``quant_conv`` and the decoder's
``post_quant_conv`` and ``conv_out`` in f32. Traps kept: the stride-2
downsample pads (0, 1) on each spatial axis (Flax ``SAME``, diffusers'
own pad; ROADMAP C3), not ``Conv2d(padding=1)``; ``quant_conv`` belongs
to the encoder's output (``lgm_tpu`` folds it there); the bottleneck's
single-head attention (D = channels) is dense.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from lgm_tpu_torch.models.unet import _conv, _gn, _linear, dense_attention

SCALING_FACTOR = 0.18215


def _gn_to(norm: nn.GroupNorm, x, dtype):
    return _gn(norm, x).to(dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        dt = self.dtype
        h = F.silu(_gn_to(self.norm1, x, dt))
        h = _conv(self.conv1, h, dt)
        h = F.silu(_gn_to(self.norm2, h, dt))
        h = _conv(self.conv2, h, dt)
        if self.conv_shortcut is not None:
            x = _conv(self.conv_shortcut, x, dt)
        return x.to(dt) + h


class Attention(nn.Module):
    """Single-head spatial self-attention at the bottleneck."""

    def __init__(self, channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        dt = self.dtype
        h = _gn_to(self.group_norm, x, dt).flatten(2).transpose(1, 2)
        q, k, v = (_linear(m, h, dt) for m in (self.to_q, self.to_k,
                                                self.to_v))
        o = _linear(self.to_out[0], dense_attention(q, k, v, C ** -0.5), dt)
        return x.to(dt) + o.transpose(1, 2).reshape(B, C, H, W)


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return _conv(self.conv, F.pad(x.to(self.dtype), (0, 1, 0, 1)),
                     self.dtype)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x.to(self.dtype), scale_factor=2, mode="nearest")
        return _conv(self.conv, x, self.dtype)


class _Block(nn.Module):
    """A down or up block: its resnets, then its resampler (if any)."""

    def __init__(self, resnets, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))
        self._sampler = sampler_name if sampler is not None else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self._sampler:
            x = getattr(self, self._sampler)[0](x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, ch: int, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, dtype),
                                      ResnetBlock2D(ch, ch, dtype)])
        self.attentions = nn.ModuleList([Attention(ch, dtype)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, chans: Sequence[int], layers: int, latent: int,
                 dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        blocks, cin = [], chans[0]
        for i, ch in enumerate(chans):
            res = [ResnetBlock2D(cin if j == 0 else ch, ch, dtype)
                   for j in range(layers)]
            last = i == len(chans) - 1
            blocks.append(_Block(res, "downsamplers",
                                 None if last else Downsample2D(ch, dtype)))
            cin = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(chans[-1], dtype)
        self.conv_norm_out = nn.GroupNorm(32, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * latent, 3, padding=1)

    def forward(self, x):
        h = _conv(self.conv_in, x, self.dtype)
        for b in self.down_blocks:
            h = b(h)
        h = self.mid_block(h)
        h = F.silu(_gn_to(self.conv_norm_out, h, self.dtype))
        return _conv(self.conv_out, h, torch.float32)


class Decoder(nn.Module):
    def __init__(self, chans: Sequence[int], layers: int, latent: int,
                 dtype):
        super().__init__()
        self.dtype = dtype
        rev = list(reversed(chans))
        self.conv_in = nn.Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], dtype)
        blocks, cin = [], rev[0]
        for i, ch in enumerate(rev):
            res = [ResnetBlock2D(cin if j == 0 else ch, ch, dtype)
                   for j in range(layers + 1)]
            last = i == len(rev) - 1
            blocks.append(_Block(res, "upsamplers",
                                 None if last else Upsample2D(ch, dtype)))
            cin = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = _conv(self.conv_in, z, self.dtype)
        h = self.mid_block(h)
        for b in self.up_blocks:
            h = b(h)
        h = F.silu(_gn_to(self.conv_norm_out, h, self.dtype))
        return _conv(self.conv_out, h, torch.float32)


class AutoencoderKL(nn.Module):
    """encode: image [B, 3, H, W] in [-1, 1] -> (mean, logvar), each
    [B, 4, H/f, W/f] f32 (logvar clipped to [-30, 20]); decode: latents
    -> image [B, 3, H, W] f32. Sampling and the 0.18215 scaling are the
    pipeline's."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels, dtype)
        self.decoder = Decoder(block_out_channels, layers_per_block,
                               latent_channels, dtype)
        self.quant_conv = nn.Conv2d(2 * latent_channels,
                                    2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode(self, x):
        moments = _conv(self.quant_conv, self.encoder(x), torch.float32)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(_conv(self.post_quant_conv, z, torch.float32))
