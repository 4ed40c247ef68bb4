"""Multi-view latent diffusion U-Net (MVDream / ImageDream) in PyTorch.

Port of ``lgm_tpu/diffusion/mv_unet.py`` (ref: mvdream/mv_unet.py:
615-1005): a Stable-Diffusion-2 latent U-Net whose transformer blocks
attend across all F frames jointly ((b f) l c -> b (f l) c), with
sinusoidal timestep embeddings ([cos, sin]), a camera MLP on flattened
4x4 poses, and ImageDream's image-prompt branch (a Perceiver
``Resampler`` turns CLIP image features into ip_dim context tokens read
by ``to_k_ip`` / ``to_v_ip`` of ``attn2``; the reference image latent
replaces the last frame of each CFG branch).

Layout NCHW; module and parameter names are the reference torch model's
(``input_blocks.{n}.{m}.in_layers.0``, ``….transformer_blocks.0.attn1.
to_q``, ``middle_block.1``, ``output_blocks.{n}.2.conv``, ``out.2``,
``image_embed.layers.{i}.0.to_kv``), so the published ``unet/`` and the
``unet_sd/`` goldens load with ``load_state_dict``.

Numerics mirror the JAX module's cast points: parameters in f32, cast to
the compute ``dtype`` at use; GroupNorm in f32 (eps 1e-6 in the
transformer, 1e-5 in the ResBlocks and at ``out.0``); LayerNorm in f32
with Flax's eps 1e-6, output in ``dtype``; ``out.2`` in f32. GEGLU's and
the Resampler's GELU are Flax's ``nn.gelu``, the tanh approximation. The
U-Net's stride-2 ``Downsample`` pads (1, 1), unlike the VAE's (0, 1).

Attention goes through ``attention``, the counterpart of ``lgm_tpu``'s
``_attention`` on its ``LGM_TPU_ATTN=kres`` route: kernel K1 (``mha``)
where ``lgm_tpu`` takes its K-resident kernel — self-attention
(Nq == Nk), Nq % 512 == 0, Nq >= 2048 or the logits over 2e8 bytes, head
dim <= 64 — and K1 takes the input (``kernel_takes``: bf16 or f32, D
32/64; at f32 the exact f32 kernels); ``models/unet.py::dense_attention``
elsewhere (the text cross-attention, the Resampler). For MVDream and
ImageDream at 256² that is the joint self-attention of level 0: S =
F·32² (4096 or 5120), D 64, 5 sites a U-Net call, in bf16 or, where a
tower computes in f32, in f32. The gate reads dtype and shape only, so the CPU takes the
card's route.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lgm_tpu_torch.models.unet import _conv, _gn, _linear, dense_attention
from lgm_tpu_torch.ops.mha import kernel_takes, mha
from lgm_tpu_torch.utils.camera import orbit_camera


def get_camera(num_frames: int, elevation: float = 0.0,
               azimuth_start: float = 0.0, azimuth_span: float = 360.0,
               blender_coord: bool = True,
               extra_view: bool = False) -> np.ndarray:
    """[F(+1), 16] flattened camera poses for conditioning
    (ref: mv_unet.py:20-39); the optional extra view (ImageDream's ip
    frame) is a zero pose."""
    gap = azimuth_span / num_frames
    cams = []
    for az in np.arange(azimuth_start, azimuth_span + azimuth_start, gap):
        pose = orbit_camera(elevation, float(az), radius=1.0)
        if blender_coord:
            pose = pose.copy()
            pose[2] *= -1
            pose[[1, 2]] = pose[[2, 1]]
        cams.append(pose.flatten())
    if extra_view:
        cams.append(np.zeros_like(cams[0]))
    return np.stack(cams).astype(np.float32)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings [N, dim] in f32, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def kernel_route(dtype: torch.dtype, B: int, heads: int, Nq: int, Nk: int,
                 hd: int) -> bool:
    """Whether ``attention`` sends [B, Nq, heads·hd] x [B, Nk, heads·hd]
    to K1: ``lgm_tpu``'s K-resident conditions and ``kernel_takes`` (bf16,
    or f32 where the tower computes in f32: the exact f32 kernels)."""
    logits_bytes = B * heads * Nq * Nk * 2
    return (Nq == Nk and Nq % 512 == 0
            and (Nq >= 2048 or logits_bytes > 2e8) and hd <= 64
            and kernel_takes(dtype, Nq, Nk, hd, float(hd) ** -0.5))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """[B, Nq, C] x [B, Nk, C] -> [B, Nq, C] multi-head attention, scale
    head_dim^-0.5: K1 where ``kernel_route`` says so, else dense."""
    B, Nq, C = q.shape
    Nk = k.shape[1]
    hd = C // heads

    def split(t, n):
        return t.reshape(B, n, heads, hd).transpose(1, 2).reshape(
            B * heads, n, hd).contiguous()

    q, k, v = split(q, Nq), split(k, Nk), split(v, Nk)
    if kernel_route(q.dtype, B, heads, Nq, Nk, hd):
        o = mha(q, k, v, float(hd) ** -0.5)
    else:
        o = dense_attention(q, k, v, float(hd) ** -0.5)
    return o.reshape(B, heads, Nq, hd).transpose(1, 2).reshape(B, Nq, C)


def _ln(norm: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """LayerNorm in f32, output in ``dtype`` (Flax's LayerNorm(dtype))."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = _linear(self.proj, x, self.dtype).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU MLP, 4x wide (ref: mv_unet.py:120-137)."""

    def __init__(self, dim: int, dtype, mult: int = 4):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return _linear(self.net[2], self.net[0](x), self.dtype)


class CrossAttention(nn.Module):
    """q from x, k/v from the context (self-attention without one); the
    ip branch reads the context's last ip_dim tokens
    (ref: mv_unet.py:139-226)."""

    def __init__(self, query_dim: int, context_dim: Optional[int],
                 heads: int, dim_head: int, dtype, ip_dim: int = 0,
                 ip_weight: float = 1.0):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dtype = heads, dtype
        self.ip_dim, self.ip_weight = ip_dim, ip_weight
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        if ip_dim > 0:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        dt = self.dtype
        ctx = x if context is None else context
        q = _linear(self.to_q, x, dt)
        ip_ctx = None
        if self.ip_dim > 0 and context is not None:
            ip_ctx = ctx[:, -self.ip_dim:]
            ctx = ctx[:, :ctx.shape[1] - self.ip_dim]
        out = attention(q, _linear(self.to_k, ctx, dt),
                        _linear(self.to_v, ctx, dt), self.heads)
        if ip_ctx is not None:
            out = out + self.ip_weight * attention(
                q, _linear(self.to_k_ip, ip_ctx, dt),
                _linear(self.to_v_ip, ip_ctx, dt), self.heads)
        return _linear(self.to_out[0], out, dt)


class BasicTransformerBlock3D(nn.Module):
    """Self-attention over all frames jointly, per-frame cross-attention
    to the context, GEGLU feed-forward (ref: mv_unet.py:229-276)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int, dtype, ip_dim: int = 0,
                 ip_weight: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.attn1 = CrossAttention(dim, None, heads, dim_head, dtype)
        self.ff = FeedForward(dim, dtype)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype,
                                    ip_dim, ip_weight)
        self.norm1 = _layer_norm(dim)
        self.norm2 = _layer_norm(dim)
        self.norm3 = _layer_norm(dim)

    def forward(self, x, context, num_frames: int):
        BF, L, C = x.shape
        dt = self.dtype
        h = x.reshape(BF // num_frames, num_frames * L, C)
        h = h + self.attn1(_ln(self.norm1, h, dt))
        x = h.reshape(BF, L, C)
        x = x + self.attn2(_ln(self.norm2, x, dt), context)
        return x + self.ff(_ln(self.norm3, x, dt))


class SpatialTransformer3D(nn.Module):
    """GN -> linear proj_in -> transformer blocks -> proj_out, residual
    (ref: mv_unet.py:279-332)."""

    def __init__(self, channels: int, heads: int, dim_head: int,
                 context_dim: int, dtype, depth: int = 1, ip_dim: int = 0,
                 ip_weight: float = 1.0):
        super().__init__()
        inner = heads * dim_head
        self.dtype = dtype
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock3D(inner, heads, dim_head, context_dim,
                                    dtype, ip_dim, ip_weight)
            for _ in range(depth))
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context, num_frames: int):
        BF, C, H, W = x.shape
        dt = self.dtype
        h = _gn(self.norm, x).to(dt).permute(0, 2, 3, 1).reshape(BF, H * W, C)
        h = _linear(self.proj_in, h, dt)
        for blk in self.transformer_blocks:
            h = blk(h, context, num_frames)
        h = _linear(self.proj_out, h, dt)
        return h.reshape(BF, H, W, C).permute(0, 3, 1, 2) + x


class PerceiverAttention(nn.Module):
    """Latents query (image features ++ latents) (ref: mv_unet.py:335-384)."""

    def __init__(self, dim: int, dim_head: int, heads: int, dtype):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dtype = heads, dtype
        self.norm1 = _layer_norm(dim)
        self.norm2 = _layer_norm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        dt = self.dtype
        x = _ln(self.norm1, x, dt)
        latents = _ln(self.norm2, latents, dt)
        q = _linear(self.to_q, latents, dt)
        k, v = _linear(self.to_kv, torch.cat([x, latents], dim=-2),
                       dt).chunk(2, dim=-1)
        return _linear(self.to_out, attention(q, k, v, self.heads), dt)


class Resampler(nn.Module):
    """Perceiver resampler: CLIP image features [B, L, embedding_dim] ->
    num_queries context tokens [B, num_queries, output_dim]
    (ref: mv_unet.py:386-428)."""

    def __init__(self, dim: int, embedding_dim: int, output_dim: int,
                 num_queries: int, dtype, depth: int = 4, dim_head: int = 64,
                 heads: int = 12, ff_mult: int = 4):
        super().__init__()
        self.dtype = dtype
        self.latents = nn.Parameter(torch.randn(1, num_queries, dim)
                                    / dim ** 0.5)
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = _layer_norm(output_dim)
        self.layers = nn.ModuleList(nn.ModuleList([
            PerceiverAttention(dim, dim_head, heads, dtype),
            nn.Sequential(_layer_norm(dim),
                          nn.Linear(dim, dim * ff_mult, bias=False),
                          nn.GELU(approximate="tanh"),
                          nn.Linear(dim * ff_mult, dim, bias=False)),
        ]) for _ in range(depth))

    def forward(self, x):
        dt = self.dtype
        latents = self.latents.expand(x.shape[0], -1, -1).to(dt)
        x = _linear(self.proj_in, x, dt)
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            h = ff[2](_linear(ff[1], _ln(ff[0], latents, dt), dt))
            latents = latents + _linear(ff[3], h, dt)
        return _ln(self.norm_out, _linear(self.proj_out, latents, dt), dt)


class ResBlock(nn.Module):
    """Time-conditioned residual block, additive embedding
    (use_scale_shift_norm=False; ref: mv_unet.py:516-612)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dtype):
        super().__init__()
        self.dtype = dtype
        self.in_layers = nn.Sequential(
            nn.GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
            nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, out_channels, eps=1e-5), nn.SiLU(),
            nn.Dropout(0.0), nn.Conv2d(out_channels, out_channels, 3,
                                       padding=1))
        self.skip_connection = (nn.Conv2d(channels, out_channels, 1)
                                if channels != out_channels else None)

    def forward(self, x, emb):
        dt = self.dtype
        h = _conv(self.in_layers[2], F.silu(_gn(self.in_layers[0], x).to(dt)),
                  dt)
        h = h + _linear(self.emb_layers[1], F.silu(emb), dt)[:, :, None, None]
        h = F.silu(_gn(self.out_layers[0], h).to(dt))
        h = _conv(self.out_layers[3], h, dt)
        if self.skip_connection is not None:
            x = _conv(self.skip_connection, x, dt)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return _conv(self.op, x, self.dtype)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return _conv(self.conv, F.interpolate(x, scale_factor=2,
                                              mode="nearest"), self.dtype)


def zero_init_modules(unet: "MultiViewUNetModel") -> List[nn.Module]:
    """The layers ``lgm_tpu``'s U-Net initialises at zero
    (``kernel_init=zeros``, ``lgm_tpu/diffusion/mv_unet.py:238-239, 344-345,
    486-488``): each SpatialTransformer3D's ``proj_out``, each ResBlock's
    ``out_layers.3`` and the final ``out.2``. With them at zero the
    untrained U-Net predicts ε = 0."""
    mods: List[nn.Module] = []
    for m in unet.modules():
        if isinstance(m, SpatialTransformer3D):
            mods.append(m.proj_out)
        elif isinstance(m, ResBlock):
            mods.append(m.out_layers[3])
    mods.append(unet.out[2])
    return mods


@torch.no_grad()
def init_like_lgm_tpu_(unet: "MultiViewUNetModel") -> None:
    """Give ``unet`` the zeros of ``lgm_tpu``'s initialisation, in place:
    every bias of a linear or convolution layer (Flax's default bias
    initialiser) and the weights of ``zero_init_modules``. The other
    weights keep PyTorch's default draws."""
    for m in unet.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
            m.bias.zero_()
    for m in zero_init_modules(unet):
        m.weight.zero_()


class MultiViewUNetModel(nn.Module):
    """The multi-view diffusion U-Net (ref: mv_unet.py:615-1005).

    forward(x [(B F), C_in, h, w], timesteps [(B F)], context
    [(B F), L, context_dim], num_frames, camera [(B F), 16], ip
    [(B F), L_img, ip_embedding_dim], ip_img [B, 4, h, w]) -> ε
    [(B F), C_out, h, w] in f32. ``ip_embedding_dim`` is the CLIP vision
    width (1280 in the published ImageDream)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_head_channels: int = 64, transformer_depth: int = 1,
                 context_dim: int = 1024, camera_dim: Optional[int] = 16,
                 ip_dim: int = 0, ip_weight: float = 1.0,
                 ip_embedding_dim: int = 1280, dtype=torch.float32):
        super().__init__()
        mc, ted = model_channels, model_channels * 4
        self.model_channels, self.ip_dim, self.dtype = mc, ip_dim, dtype
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        self.camera_embed = (nn.Sequential(nn.Linear(camera_dim, ted),
                                           nn.SiLU(), nn.Linear(ted, ted))
                             if camera_dim is not None else None)
        if ip_dim > 0:
            self.image_embed = Resampler(context_dim, ip_embedding_dim,
                                         context_dim, ip_dim, dtype)

        def st(ch):
            return SpatialTransformer3D(
                ch, ch // num_head_channels, num_head_channels, context_dim,
                dtype, transformer_depth, ip_dim, ip_weight)

        def block(*mods):
            return nn.ModuleList(mods)

        blocks = [block(nn.Conv2d(in_channels, mc, 3, padding=1))]
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                mods = [ResBlock(ch, ted, mult * mc, dtype)]
                ch = mult * mc
                if ds in attention_resolutions:
                    mods.append(st(ch))
                blocks.append(block(*mods))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(block(Downsample(ch, dtype)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = block(ResBlock(ch, ted, ch, dtype), st(ch),
                                  ResBlock(ch, ted, ch, dtype))
        blocks = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                mods = [ResBlock(ch + chans.pop(), ted, mult * mc, dtype)]
                ch = mult * mc
                if ds in attention_resolutions:
                    mods.append(st(ch))
                if level and i == num_res_blocks:
                    mods.append(Upsample(ch, dtype))
                    ds //= 2
                blocks.append(block(*mods))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(nn.GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    def _run(self, mods, h, emb, context, num_frames):
        for m in mods:
            if isinstance(m, ResBlock):
                h = m(h, emb)
            elif isinstance(m, SpatialTransformer3D):
                h = m(h, context, num_frames)
            elif isinstance(m, nn.Conv2d):
                h = _conv(m, h, self.dtype)
            else:
                h = m(h)
        return h

    def forward(self, x, timesteps, context, num_frames: int, camera=None,
                ip=None, ip_img=None):
        dt = self.dtype
        emb = _linear(self.time_embed[0],
                      timestep_embedding(timesteps, self.model_channels), dt)
        emb = _linear(self.time_embed[2], F.silu(emb), dt)
        if camera is not None:
            c = _linear(self.camera_embed[0], camera, dt)
            emb = emb + _linear(self.camera_embed[2], F.silu(c), dt)
        if self.ip_dim > 0:
            if ip is None or ip_img is None:
                raise ValueError("an ImageDream U-Net needs ip and ip_img")
            BF = x.shape[0]
            x = x.reshape(BF // num_frames, num_frames, *x.shape[1:]).clone()
            x[:, num_frames - 1] = ip_img
            x = x.reshape(BF, *x.shape[2:])
            context = torch.cat([context.to(dt), self.image_embed(ip)], dim=1)

        hs: List[torch.Tensor] = []
        h = x
        for mods in self.input_blocks:
            h = self._run(mods, h, emb, context, num_frames)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, num_frames)
        for mods in self.output_blocks:
            h = self._run(mods, torch.cat([h, hs.pop()], dim=1), emb,
                          context, num_frames)
        h = F.silu(_gn(self.out[0], h).to(dt))
        return _conv(self.out[2], h, torch.float32)
