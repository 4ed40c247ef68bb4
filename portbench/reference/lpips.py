"""Plain LPIPS (VGG-16 tower) and LGM's training loss.

A frozen copy of LPIPS's distance as LGM uses it (core/models.py): the
inputs in [-1, 1] shifted and scaled per channel, the VGG-16 conv tower
(2, 2, 3, 3, 3 convolutions of 64, 128, 256, 512, 512 channels, ReLU, 2x2
max-pool between stages), each stage's tap unit-normalised over channels
(eps 1e-10 under the root), the squared difference weighted per channel by
``|lin|``, averaged over space and summed over the taps. The supervision
views are first resized to 256² by the bilinear taps of
``F.interpolate(align_corners=False, antialias=False)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import full

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def param_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes, cin = {}, 3
    for si, (n, ch) in enumerate(STAGES):
        for ci in range(n):
            shapes[f"vgg.conv{si}_{ci}.weight"] = (ch, cin, 3, 3)
            shapes[f"vgg.conv{si}_{ci}.bias"] = (ch,)
            cin = ch
        shapes[f"lin{si}"] = (ch,)
    return shapes


def _taps(p, x, q):
    taps = []
    for si, (n, _) in enumerate(STAGES):
        for ci in range(n):
            name = f"vgg.conv{si}_{ci}"
            x = F.relu(F.conv2d(q(x), q(p[f"{name}.weight"]),
                                p[f"{name}.bias"], padding=1))
        taps.append(x)
        if si < len(STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def lpips(p: dict, a: torch.Tensor, b: torch.Tensor,
          q: Callable = full) -> torch.Tensor:
    """Distance [N] between NCHW images in [-1, 1]."""
    shift = torch.tensor(SHIFT, device=a.device).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=a.device).view(1, 3, 1, 1)
    total = 0.0
    for si, (xa, xb) in enumerate(zip(_taps(p, (a - shift) / scale, q),
                                      _taps(p, (b - shift) / scale, q))):
        na = xa / torch.sqrt((xa * xa).sum(dim=1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt((xb * xb).sum(dim=1, keepdim=True) + 1e-10)
        w = p[f"lin{si}"].abs().view(1, -1, 1, 1)
        total = total + ((na - nb) ** 2 * w).sum(dim=1).mean(dim=(1, 2))
    return total


def bilinear_taps(s_in: int, s_out: int) -> np.ndarray:
    """[s_out, s_in] row-stochastic taps of a bilinear resize."""
    src = np.clip((np.arange(s_out) + 0.5) * (s_in / s_out) - 0.5,
                  0.0, s_in - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, s_in - 1)
    frac = (src - i0).astype(np.float32)
    w = np.zeros((s_out, s_in), np.float32)
    w[np.arange(s_out), i0] += 1.0 - frac
    w[np.arange(s_out), i1] += frac
    return w


def to_256(x: torch.Tensor) -> torch.Tensor:
    """[N, 3, S, S] -> [N, 3, 256, 256] (unchanged at S <= 256)."""
    s = x.shape[2]
    if s <= 256:
        return x
    w = torch.as_tensor(bilinear_taps(s, 256), device=x.device)
    return torch.einsum("ow,nchw->ncho", w,
                        torch.einsum("oh,nchw->ncow", w, x))


def view_loss(p_lpips: dict, pred: torch.Tensor, alpha: torch.Tensor,
              image: torch.Tensor, mask: torch.Tensor, bg: torch.Tensor,
              lambda_lpips: float, q: Callable = full) -> torch.Tensor:
    """One supervision view's part of LGM's loss, before the mean over the
    views: MSE of the image over ``bg`` and of the alpha, plus
    ``lambda_lpips`` x LPIPS(gt, pred). pred, image [S, S, 3]; alpha [S,
    S]; mask [S, S, 1]."""
    gt = image * mask + bg * (1.0 - mask)
    loss = ((pred - gt) ** 2).mean() + ((alpha[..., None] - mask) ** 2).mean()
    if lambda_lpips > 0:
        def nchw(x):
            return to_256(x.permute(2, 0, 1)[None] * 2 - 1)
        loss = loss + lambda_lpips * lpips(p_lpips, nchw(gt), nchw(pred),
                                           q)[0]
    return loss
