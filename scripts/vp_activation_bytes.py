#!/usr/bin/env python3
"""Reckon, from the shapes, the U-Net activation bytes one vp rank holds
for the backward of LGM ``big``'s training step, for vp 1, 2 and 4.

Nothing runs on a device: the port's U-Net is built on PyTorch's ``meta``
device and run forward on a [B·V/vp, 9, 256, 256] meta input (each vp rank
of the view-sharded U-Net runs its own V/vp input views of every scene),
and every tensor autograd saves for the backward is counted once
(``torch.autograd.graph.saved_tensors_hooks``); the compute-dtype copies
of the weights, the same on every rank, are counted apart. The
cross-view attention is replaced by a stand-in whose residuals are
counted from the shapes:
K1's q, o and f32 row logsumexp for the rank's S/vp queries, and the
gathered k and v of all S tokens (``ops/mha.py::_MHAViews``).

Two figures a vp degree:
- ``no_remat``: every saved tensor of the forward;
- ``remat`` (``unet_remat``, the preset's default): the tensors handed
  from block to block (each recomputed block keeps its inputs), the
  saved tensors outside the blocks, and the largest single block's saved
  tensors, live while that block is recomputed in the backward.

Run: python scripts/vp_activation_bytes.py [--batch 2] [--views 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lgm_tpu_torch.config import CONFIGS  # noqa: E402
from lgm_tpu_torch.models import unet as unet_mod  # noqa: E402


class _Attention(torch.autograd.Function):
    """Meta stand-in of the attention: o of q's shape, no saved tensor
    (its residuals are counted by ``reckon``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, g):
        return g, g, g


def reckon(batch: int, views: int, vp: int) -> dict:
    opt = CONFIGS["big"]
    with torch.device("meta"):
        net = unet_mod.UNet(
            9, 14, down_channels=opt.down_channels,
            down_attention=opt.down_attention,
            mid_attention=opt.mid_attention, up_channels=opt.up_channels,
            up_attention=opt.up_attention, dtype=torch.bfloat16)
    seen, kept = set(), []
    # The compute-dtype copies of the weights that convolutions and dense
    # layers save: the same on every rank, whatever vp.
    weight_shapes = {tuple(p.shape) for p in net.parameters()}
    weights = [0]
    buckets = {"outside": 0}
    current = ["outside"]
    attn_bytes = {"outside": 0}
    boundary = set()
    boundary_bytes = [0]

    def nbytes(t):
        return t.numel() * t.element_size()

    def pack(t):
        if id(t) not in seen:
            seen.add(id(t))
            kept.append(t)
            if tuple(t.shape) in weight_shapes:
                weights[0] += nbytes(t)
            else:
                buckets[current[0]] = buckets.get(current[0], 0) + nbytes(t)
        return t

    def attention(q, k, v, scale, group=None):
        BH, Sq, D = q.shape
        Sk = Sq * vp
        # q, o (bf16) and the f32 row statistic for Sq rows; k, v gathered.
        attn_bytes[current[0]] = (attn_bytes.get(current[0], 0)
                                  + 2 * BH * Sq * D * 2 + BH * Sq * 4
                                  + 2 * BH * Sk * D * 2)
        return _Attention.apply(q, k, v)

    def enter(name):
        def hook(module, args):
            current[0] = name
            for a in args:
                for t in (a if isinstance(a, (list, tuple)) else [a]):
                    if torch.is_tensor(t) and id(t) not in boundary:
                        boundary.add(id(t))
                        kept.append(t)
                        boundary_bytes[0] += nbytes(t)
        return hook

    def leave(module, args, out):
        current[0] = "outside"

    blocks = ([(f"down{i}", b) for i, b in enumerate(net.down_blocks)]
              + [("mid", net.mid_block)]
              + [(f"up{i}", b) for i, b in enumerate(net.up_blocks)])
    for name, blk in blocks:
        blk.register_forward_pre_hook(enter(name))
        blk.register_forward_hook(leave)
    orig = unet_mod.attention
    unet_mod.attention = attention
    try:
        x = torch.empty(batch * views // vp, 9, opt.input_size,
                        opt.input_size, device="meta")
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            net(x, views // vp)
    finally:
        unet_mod.attention = orig
    per_block = {k: buckets.get(k, 0) + attn_bytes.get(k, 0)
                 for k in set(buckets) | set(attn_bytes)}
    outside = per_block.pop("outside")
    total = outside + sum(per_block.values())
    largest = max(per_block, key=per_block.get)
    return {"vp": vp, "views_per_rank": views // vp,
            "no_remat_gib": total / 2 ** 30,
            "remat_gib": (outside + boundary_bytes[0]
                          + per_block[largest]) / 2 ** 30,
            "block_inputs_gib": boundary_bytes[0] / 2 ** 30,
            "largest_block": largest,
            "largest_block_gib": per_block[largest] / 2 ** 30,
            "attention_residuals_gib": sum(attn_bytes.values()) / 2 ** 30,
            "weight_copies_gib": weights[0] / 2 ** 30}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--views", type=int, default=4)
    ns = ap.parse_args(argv)
    for vp in (1, 2, 4):
        print(json.dumps({"batch": ns.batch, "views": ns.views,
                          **reckon(ns.batch, ns.views, vp)}))


if __name__ == "__main__":
    main()
