"""Plain LGM training steps: the loss of a batch, its gradients, AdamW.

The optimizer is a frozen copy of LGM's (main.py: AdamW, lr 4e-4 under a
cosine one-cycle schedule with 3,000 warm-up steps, betas 0.9 / 0.95,
weight decay 0.05, eps 1e-8, the gradient clipped to global norm 1.0) as
the port keeps it: optax's order, the first moment stored in bf16 with
b1 rounded to bf16 (0.8984375) and the product and sum in f32, bias
corrections in f32.

A batch's gradient is taken scene by scene and view by view, which gives
the same sums as the whole batch at once and fits the f32 activations:
each scene's Gaussians are a leaf, each supervision view's loss is
back-propagated to it alone, and then the Gaussians' gradient through the
U-Net.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import lgm as ref_lgm
from portbench.reference.lpips import view_loss
from portbench.reference.precision import PRECISIONS, Precision
from portbench.reference.render import render_view
from portbench.reference.scenes import tan_half_fov

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.05
B1_BF16 = float(torch.tensor(B1, dtype=torch.bfloat16))


def learning_rate(cfg: dict, count: int) -> float:
    """optax.cosine_onecycle_schedule(max(total, warmup + 1), lr,
    warmup / total, div 25, final div 1e4) at ``count``, in f32."""
    total = max(cfg["total_steps"], cfg["warmup_steps"] + 1)
    bounds = [0, int(cfg["warmup_steps"] / total * total), int(total)]
    values = np.cumprod([cfg["lr"] / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    f32 = np.float32
    if count >= bounds[-1]:
        return float(f32(values[-1]))
    for i in range(2):
        lo, hi = bounds[i], bounds[i + 1]
        if lo <= count < hi:
            pct = f32(count - lo) / f32(hi - lo)
            half = f32((values[i] - values[i + 1]) / 2.0)
            return float(f32(values[i + 1])
                         + half * (f32(np.cos(f32(np.pi) * pct)) + f32(1)))
    raise ValueError(count)


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict):
        self.cfg = cfg
        self.count = 0
        self.mu = {k: torch.zeros_like(v, dtype=torch.bfloat16)
                   for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients."""
        clip = self.cfg["gradient_clip"]
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        lr = learning_rate(self.cfg, self.count)
        self.count += 1
        bc1 = 1 - torch.tensor(B1, device=norm.device) ** self.count
        bc2 = 1 - torch.tensor(B2, device=norm.device) ** self.count
        clipped = {}
        for k, p in params.items():
            g = torch.where(norm < clip, grads[k], grads[k] / norm * clip)
            clipped[k] = g
            mu = (1 - B1) * g + B1_BF16 * self.mu[k].float()
            self.nu[k].mul_(B2).add_((1 - B2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            p.add_((u + WEIGHT_DECAY * p) * (-lr))
            self.mu[k].copy_(mu)
        return clipped


def batch_loss_and_grads(p_lgm: Dict[str, torch.Tensor], p_lpips: dict,
                         data: dict, bg: torch.Tensor, cfg: dict,
                         prec: Precision = PRECISIONS["fp32"]):
    """LGM's loss over a batch, its gradient for every LGM weight (mean
    over the B x V supervision views) and each scene's Gaussians."""
    for v in p_lgm.values():
        v.requires_grad_(True)
        v.grad = None
    B, V = data["cam_view"].shape[:2]
    tan = tan_half_fov(cfg)
    total, made = 0.0, []
    for b in range(B):
        g = ref_lgm.gaussians(p_lgm, data["input"][b:b + 1], cfg,
                              prec.q)[0]
        made.append(g.detach().cpu())
        leaf = g.detach().requires_grad_(True)
        for v in range(V):
            pred, alpha = render_view(
                leaf, data["cam_view"][b, v], cfg["output_size"], tan, bg,
                cfg["rasterizer_dup"], cfg["tile_h"], cfg["tile_w"],
                cfg["max_gaussians_per_tile"], prec.render)
            loss = view_loss(p_lpips, pred, alpha,
                             data["images_output"][b, v],
                             data["masks_output"][b, v], bg,
                             cfg["lambda_lpips"], prec.q) / (B * V)
            loss.backward()
            total += float(loss.detach())
        g.backward(leaf.grad)
    grads = {k: v.grad for k, v in p_lgm.items()}
    for v in p_lgm.values():
        v.requires_grad_(False)
        v.grad = None
    return total, grads, torch.stack(made)


def follow(p0: Dict[str, torch.Tensor], p_lpips: dict, batches: List[dict],
           bgs: List[torch.Tensor], cfg: dict,
           prec: Precision = PRECISIONS["fp32"]) -> dict:
    """LGM training from weights ``p0`` over one step a batch: the loss of
    each step, each weight's first gradient as the optimizer takes it
    (clipped) and its change over all the steps, as norms, and the first
    step's Gaussians of each scene."""
    params = {k: v.detach().clone() for k, v in p0.items()}
    adam = AdamW(params, cfg)
    losses, first, made = [], None, None
    for data, bg in zip(batches, bgs):
        loss, grads, gaussians = batch_loss_and_grads(
            params, p_lpips, data, bg, cfg, prec)
        clipped = adam.step(params, grads)
        losses.append(loss)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g))
                     for k, g in clipped.items()}
            made = gaussians
        del grads, clipped
    change = {k: float(torch.linalg.vector_norm(params[k] - p0[k]))
              for k in params}
    return {"losses": losses, "grad": first, "gaussians": made,
            "change": change}
