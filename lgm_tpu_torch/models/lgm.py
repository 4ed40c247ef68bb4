"""LGM: multi-view U-Net -> per-pixel Gaussians -> differentiable render.

Port of ``lgm_tpu/models/lgm.py`` (ref: core/models.py:14-174):
``activate_gaussians``, ``LGM`` and the training graph ``LGMWithLoss``
(render every supervision view, MSE on image and alpha, the optional
scale guard and LPIPS).

Data contract (NHWC at the public functions, as in JAX):
  input          [B, V_in, H, W, 9]  ImageNet-normalized RGB + Plücker rays
  images_output  [B, V, S, S, 3]     supervision RGB in [0, 1]
  masks_output   [B, V, S, S, 1]
  cam_view       [B, V, 4, 4]        transposed w2c (reference layout)
  -> Gaussians [B, V_in * splat^2, 14]
     pos(3) | opacity(1) | scale(3) | quat wxyz(4) | rgb(3)
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lgm_tpu_torch import trace
from lgm_tpu_torch.config import Options
from lgm_tpu_torch.models.init import init_like_flax_
from lgm_tpu_torch.models.lpips import (LPIPS, GraphedFold, grad_seed,
                                        value_and_grad)
from lgm_tpu_torch.models.unet import UNet
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.parallel import dist


def activate_gaussians(x: torch.Tensor) -> torch.Tensor:
    """Per-attribute activations on raw U-Net output [..., N, 14]
    (ref: core/models.py:40-44): pos clamp(-1, 1) | opacity sigmoid |
    scale 0.1 * softplus | rgb 0.5 * tanh + 0.5.

    Rotation (trap C1): the reference's ``F.normalize`` runs with torch's
    default ``dim=1``, which on [B, N, 4] normalizes each quaternion
    COMPONENT across the N Gaussians, not each quaternion; the result is
    used raw. Here that is ``dim=-2`` with eps 1e-12, so an all-zero
    column stays zero."""
    pos = x[..., 0:3].clamp(-1.0, 1.0)
    opacity = torch.sigmoid(x[..., 3:4])
    scale = 0.1 * F.softplus(x[..., 4:7])
    rot = F.normalize(x[..., 7:11], p=2.0, dim=-2, eps=1e-12)
    rgb = 0.5 * torch.tanh(x[..., 11:14]) + 0.5
    return torch.cat([pos, opacity, scale, rot, rgb], dim=-1)


class LGM(nn.Module):
    """Splatter-image regressor: ``model(images)`` -> activated Gaussians
    [B, V_in * splat^2, 14]. The view count comes from the input shape.
    Given a ``generator``, every conv and dense (the U-Net's, then the
    final 1x1) starts from flax's initialisers, as ``lgm_tpu``'s LGM does
    (``models/init.py``); without one, from PyTorch's, for weights that
    are loaded next.

    ``views_group`` (None: one process) is the vp group of a view-sharded
    U-Net (``parallel/dist.py``): ``images`` then holds this rank's V/vp
    views of each scene, and the Gaussians of the group's views are
    gathered in view order before activation, as lgm_tpu's
    ``gather_gaussians``, so every rank returns all of them.

    A call is the range ``lgm`` of a profiled run, and its backward, to the
    end of the backward pass, the range ``lgm.backward``
    (``lgm_tpu_torch/trace.py``)."""

    def __init__(self, opt: Options, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.opt = opt
        self.unet = UNet(
            9, 14,
            down_channels=opt.down_channels,
            down_attention=opt.down_attention,
            mid_attention=opt.mid_attention,
            up_channels=opt.up_channels,
            up_attention=opt.up_attention,
            dtype=dtype,
            remat=opt.unet_remat,
        )
        # Final 1x1 conv, in f32 (ref: core/models.py:34).
        self.conv = nn.Conv2d(14, 14, 1)
        self.views_group = None
        if generator is not None:
            init_like_flax_(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with trace.span("lgm"):
            bwd = trace.backward_span("lgm.backward")
            images = bwd.inputs(images)
            B, V, H, W, C = images.shape
            x = images.reshape(B * V, H, W, C).permute(0, 3, 1, 2)
            x = self.unet(x, V, self.views_group)
            x = F.conv2d(x.float(), self.conv.weight.float(),
                         self.conv.bias.float())
            s = self.opt.splat_size
            # [B*V, 14, s, s] -> [B, V*s*s, 14] in (view, row, col) order.
            x = x.permute(0, 2, 3, 1).reshape(B, V * s * s, 14)
            if self.views_group is not None:
                # Before the activation: its quaternion normalisation runs
                # across all of a scene's Gaussians (trap C1).
                x = dist.gather_views(x, 1, self.views_group)
            return bwd.outputs(activate_gaussians(x))[0]


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse) (ref: core/models.py:170-172)."""
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, V, S, S, 3] -> [B*V, 3, S, S]."""
    B, V, S = x.shape[:3]
    return x.permute(0, 1, 4, 2, 3).reshape(B * V, 3, S, S)


def _torch_bilinear_matrix(s_in: int, s_out: int) -> np.ndarray:
    """[s_out, s_in] row-stochastic matrix reproducing
    ``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``
    along one axis: output i samples src = (i + 0.5) * s_in / s_out - 0.5
    with taps floor(src), floor(src) + 1 (edge-clamped) and weights
    (1 - frac, frac)."""
    src = (np.arange(s_out) + 0.5) * (s_in / s_out) - 0.5
    src = np.clip(src, 0.0, s_in - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, s_in - 1)
    frac = (src - i0).astype(np.float32)
    w = np.zeros((s_out, s_in), dtype=np.float32)
    w[np.arange(s_out), i0] += 1.0 - frac
    w[np.arange(s_out), i1] += frac
    return w


def _resize_nchw_256(x: torch.Tensor) -> torch.Tensor:
    """[N, 3, S, S] -> [N, 3, 256, 256] (pass-through if S <= 256): the
    reference's bilinear downsample of the LPIPS input (ref:
    core/models.py:156-163), as lgm_tpu applies it: the tap matrix as two
    separable matmuls."""
    s = x.shape[2]
    if s <= 256:
        return x
    w = torch.as_tensor(_torch_bilinear_matrix(s, 256), device=x.device)
    x = torch.einsum("oh,nchw->ncow", w, x)
    return torch.einsum("ow,nchw->ncho", w, x)


def rasterizer_backend(name: str) -> str:
    """lgm_tpu's ``rasterizer`` option -> the port's ``render_views``
    backend: its flatsort for "auto"/"pallas", the v1 tiled rasterizer for
    "pallas_v1", the oracle for "xla"."""
    backends = {"auto": "flatsort", "pallas": "flatsort", "flatsort":
                "flatsort", "pallas_v1": "pallas_v1", "xla": "reference",
                "reference": "reference"}
    if name not in backends:
        raise ValueError(f"unknown rasterizer {name!r}; one of "
                         f"{sorted(backends)}")
    return backends[name]


def _lpips_nchw(lpips: LPIPS, gt: torch.Tensor, pr: torch.Tensor
                ) -> torch.Tensor:
    """LPIPS of NCHW pairs: [c] distances."""
    return lpips(gt.permute(0, 2, 3, 1), pr.permute(0, 2, 3, 1))


class _FoldedMean(torch.autograd.Function):
    """The mean of ``values``, whose gradient to ``pr`` for an upstream
    gradient of 1 was formed in the forward (``grad``): the backward only
    scales it."""

    @staticmethod
    def forward(ctx, pr, values, grad):
        ctx.save_for_backward(grad)
        return values.mean()

    @staticmethod
    def backward(ctx, grad_out):
        grad, = ctx.saved_tensors
        return grad_out * grad, None, None


class LGMWithLoss(nn.Module):
    """Training graph (ref: core/models.py:120-174): Gaussians from
    ``lgm``, every [B, V] supervision view rendered with gradient, the full
    loss stack. ``lpips_loss`` is frozen (no gradient, no optimizer
    state); it exists when ``opt.lambda_lpips > 0``. The rasterizer and the
    loss run in f32 whatever ``dtype`` the networks compute in.
    ``generator`` draws both networks' initial weights, the LGM's first
    (``LGM``, ``LPIPS``). In a profiled run LPIPS is the range ``lpips``
    and its backward ``lpips.backward``; the LGM and the renderer open
    their own."""

    def __init__(self, opt: Options, dtype=torch.bfloat16,
                 backend: str = "flatsort",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.opt = opt
        self.dtype = dtype
        self.backend = rasterizer_backend(backend)
        self.lgm = LGM(opt, dtype, generator)
        self.lpips_loss = (LPIPS(dtype=dtype, generator=generator)
                           if opt.lambda_lpips > 0 else None)
        # LPIPS's captured folds by chunk shape and mean's count, all in
        # one memory pool, and the addresses of the LPIPS tensors they read.
        self._lpips_graphs: Dict[tuple, GraphedFold] = {}
        self._lpips_at: tuple = ()

    def _lpips_graph(self, gt: torch.Tensor, pr: torch.Tensor,
                     n: int) -> GraphedFold:
        """The captured fold of chunks shaped as ``gt`` and ``pr`` of a
        mean over ``n``, captured on its key's first call into the memory
        pool of the folds before it; all are dropped once LPIPS's tensors
        lie elsewhere (replaced, not updated in place)."""
        at = tuple(t.data_ptr() for t in itertools.chain(
            self.lpips_loss.parameters(), self.lpips_loss.buffers()))
        if at != self._lpips_at:
            self._lpips_graphs.clear()
            self._lpips_at = at
        key = (tuple(pr.shape), pr.dtype, pr.device, n)
        graph = self._lpips_graphs.get(key)
        if graph is None:
            pool = next((g.pool() for g in self._lpips_graphs.values()), None)
            graph = self._lpips_graphs[key] = GraphedFold(
                functools.partial(_lpips_nchw, self.lpips_loss), gt, pr, n,
                pool)
        return graph

    def _lpips(self, pred_images, gt_images) -> torch.Tensor:
        """Mean LPIPS over the B*V pairs, NCHW in [-1, 1] at <= 256², in
        chunks of 4 pairs; one chunk's VGG activations are live at a time
        (lgm_tpu's nn.scan + remat). Where the prediction needs a
        gradient, each chunk's gradient of the mean is formed in the
        forward while its activations are live (``value_and_grad``, on
        CUDA one replay of its ``GraphedFold``), and the
        backward scales it."""
        pr = _resize_nchw_256(_to_nchw(pred_images) * 2 - 1).to(self.dtype)
        gt = _resize_nchw_256(_to_nchw(gt_images) * 2 - 1).to(self.dtype)
        n = pr.shape[0]
        chunk = next(c for c in (4, 2, 1) if n % c == 0)
        fn = functools.partial(_lpips_nchw, self.lpips_loss)
        if not pr.requires_grad:
            return torch.cat([fn(gt[i:i + chunk], pr[i:i + chunk])
                              for i in range(0, n, chunk)]).mean()
        prd = pr.detach()
        if pr.is_cuda:
            fold = self._lpips_graph(gt[:chunk], prd[:chunk], n)
        else:
            fold = functools.partial(value_and_grad, fn,
                                     seed=grad_seed(chunk, n, pr.device))
        values = torch.empty(n, dtype=torch.float32, device=pr.device)
        grad = torch.empty_like(prd)
        for i in range(0, n, chunk):
            values[i:i + chunk], grad[i:i + chunk] = fold(gt[i:i + chunk],
                                                          prd[i:i + chunk])
        return _FoldedMean.apply(pr, values, grad)

    def forward(self, data: Dict[str, torch.Tensor],
                bg_color: torch.Tensor) -> Dict[str, torch.Tensor]:
        opt = self.opt
        gaussians = self.lgm(data["input"])
        tan_half_fov = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
        B, V = data["cam_view"].shape[:2]
        bg = torch.broadcast_to(bg_color.float(), (B, V, 3))
        rendered = render_views(
            gaussians.float(), data["cam_view"], opt.output_size,
            tan_half_fov, bg_color=bg, backend=self.backend,
            # The loss reads image and alpha only (R = 9 slot rows).
            with_depth=False, tile_h=opt.tile_h, tile_w=opt.tile_w,
            max_per_tile=opt.max_gaussians_per_tile,
            dup=opt.rasterizer_dup or 16)
        pred_images = rendered["image"]   # [B, V, S, S, 3]
        pred_alphas = rendered["alpha"]   # [B, V, S, S, 1]

        gt_masks = data["masks_output"]
        gt_images = (data["images_output"] * gt_masks
                     + bg[:, :, None, None, :] * (1.0 - gt_masks))
        loss_mse = ((pred_images - gt_images) ** 2).mean() \
            + ((pred_alphas - gt_masks) ** 2).mean()
        loss = loss_mse
        out = {
            "gaussians": gaussians,
            "images_pred": pred_images,
            "alphas_pred": pred_alphas,
            "loss_mse": loss_mse,
            "psnr": psnr(pred_images.detach(), gt_images),
        }

        if opt.lambda_scale_reg > 0:
            # Collapse guard: only splats wider than 0.1 scene units pay.
            loss_reg = F.relu(gaussians[..., 4:7].float() - 0.1).mean()
            out["loss_reg"] = loss_reg
            loss = loss + opt.lambda_scale_reg * loss_reg

        if self.lpips_loss is not None:
            with trace.span("lpips"):
                bwd = trace.backward_span("lpips.backward")
                loss_lpips, = bwd.outputs(
                    self._lpips(bwd.inputs(pred_images), gt_images))
            out["loss_lpips"] = loss_lpips
            loss = loss + opt.lambda_lpips * loss_lpips

        out["loss"] = loss
        return out
