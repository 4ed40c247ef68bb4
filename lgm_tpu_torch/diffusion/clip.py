"""CLIP text and vision towers, written out in PyTorch.

``lgm_tpu`` builds transformers' Flax CLIP (``pipeline.py::_build_clip``)
from ``CLIPTextConfig`` / ``CLIPVisionConfig`` with the widths of its
``PipelineConfig`` and reads ``last_hidden_state`` of the text tower and
``hidden_states[-2]`` of the vision tower. The card host has no
``transformers``, so the port writes both towers itself, under
transformers' torch state-dict names (``text_model.encoder.layers.{i}.
self_attn.q_proj.weight``, ``vision_model.pre_layrnorm.weight``, ...), so
a published ``text_encoder/`` or ``image_encoder/`` loads as it is.

What ``lgm_tpu`` runs, kept here: the configs give no ``hidden_act``, so
both towers use transformers' default ``quick_gelu`` (x·σ(1.702x)), not
the exact GELU of the published configs (ROADMAP open question); LayerNorm
eps 1e-5; the text tower masks future tokens (causal) and adds learned
position embeddings; the vision tower prepends the class embedding,
applies ``pre_layrnorm`` before the encoder and returns the penultimate
layer's output without ``post_layernorm``. Both run in f32, as the Flax
towers do; attention is ``models/unet.py::dense_attention`` (77 or 257
tokens).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.unet import dense_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        B, L, C = x.shape
        hd = C // self.heads

        def heads(t):
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        o = dense_attention(q, k, v, hd ** -0.5, causal)
        return self.out_proj(o.transpose(1, 2).reshape(B, L, C))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = CLIPMLP(hidden, 4 * hidden)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, eps: float):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(hidden, heads, eps) for _ in range(layers))


class _TextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden: int, max_positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden)
        self.position_embedding = nn.Embedding(max_positions, hidden)


class _TextTransformer(nn.Module):
    def __init__(self, vocab_size, hidden, layers, heads, max_positions,
                 eps):
        super().__init__()
        self.embeddings = _TextEmbeddings(vocab_size, hidden, max_positions)
        self.encoder = CLIPEncoder(hidden, layers, heads, eps)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=eps)


class CLIPTextModel(nn.Module):
    """Token ids [B, L] -> last hidden state [B, L, hidden] (f32)."""

    def __init__(self, vocab_size: int, hidden: int, layers: int,
                 heads: int, max_positions: int, eps: float = 1e-5):
        super().__init__()
        self.text_model = _TextTransformer(vocab_size, hidden, layers, heads,
                                           max_positions, eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        pos = torch.arange(ids.shape[1], device=ids.device)
        h = (tm.embeddings.token_embedding(ids)
             + tm.embeddings.position_embedding(pos)[None])
        for layer in tm.encoder.layers:
            h = layer(h, causal=True)
        return tm.final_layer_norm(h)


class _VisionEmbeddings(nn.Module):
    def __init__(self, hidden: int, image_size: int, patch_size: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.randn(hidden))
        self.patch_embedding = nn.Conv2d(3, hidden, patch_size,
                                         stride=patch_size, bias=False)
        n = (image_size // patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, hidden)


class _VisionTransformer(nn.Module):
    def __init__(self, hidden, layers, heads, image_size, patch_size, eps):
        super().__init__()
        self.embeddings = _VisionEmbeddings(hidden, image_size, patch_size)
        self.pre_layrnorm = nn.LayerNorm(hidden, eps=eps)
        self.encoder = CLIPEncoder(hidden, layers, heads, eps)
        self.post_layernorm = nn.LayerNorm(hidden, eps=eps)


class CLIPVisionModel(nn.Module):
    """Pixels [B, 3, S, S] (normalized) -> the penultimate layer's hidden
    state [B, (S/patch)² + 1, hidden] (f32), transformers'
    ``hidden_states[-2]``: the last encoder layer and ``post_layernorm``
    are not run."""

    def __init__(self, hidden: int, layers: int, heads: int,
                 image_size: int, patch_size: int, eps: float = 1e-5):
        super().__init__()
        self.vision_model = _VisionTransformer(hidden, layers, heads,
                                               image_size, patch_size, eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        p = emb.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.expand(p.shape[0], 1, -1)
        h = torch.cat([cls, p], dim=1) + emb.position_embedding.weight[None]
        h = vm.pre_layrnorm(h)
        for layer in vm.encoder.layers[:-1]:
            h = layer(h, causal=False)
        return h
