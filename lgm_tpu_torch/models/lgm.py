"""LGM forward: multi-view U-Net -> per-pixel Gaussians.

Port of the inference half of ``lgm_tpu/models/lgm.py``
(``activate_gaussians`` and ``LGM.__call__``; ref: core/models.py:14-117).
The loss (``LGMWithLoss``) and LPIPS arrive with the training slice.

Data contract (NHWC at the public function, as in JAX):
  images [B, V_in, H, W, 9]  ImageNet-normalized RGB + Plücker rays
  -> Gaussians [B, V_in * splat^2, 14]
     pos(3) | opacity(1) | scale(3) | quat wxyz(4) | rgb(3)
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from lgm_tpu_torch.config import Options
from lgm_tpu_torch.models.unet import UNet


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
    [B, V_in * splat^2, 14]. The view count comes from the input shape."""

    def __init__(self, opt: Options, dtype=torch.bfloat16):
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
        )
        # Final 1x1 conv, in f32 (ref: core/models.py:34).
        self.conv = nn.Conv2d(14, 14, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, V, H, W, C = images.shape
        x = images.reshape(B * V, H, W, C).permute(0, 3, 1, 2)
        x = self.unet(x, V)
        x = F.conv2d(x.float(), self.conv.weight.float(),
                     self.conv.bias.float())
        s = self.opt.splat_size
        # [B*V, 14, s, s] -> [B, V*s*s, 14] in (view, row, col) order.
        x = x.permute(0, 2, 3, 1).reshape(B, V * s * s, 14)
        return activate_gaussians(x)
