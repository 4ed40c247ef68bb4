"""Plain full-image Gaussian splat compositor: the correctness oracle.

Port of ``lgm_tpu/ops/gsplat/reference.py``: project all N Gaussians,
depth-sort once, then alpha-composite front to back over the whole image
in fixed-size chunks, the per-Gaussian recurrence inside a chunk being an
exclusive cumulative product. There is no tiling, no per-tile cap and no
early-out (the remaining transmittance bounds that difference, < 1e-4 per
channel), so it is the exact reference the flatsort path is held to.
"""

from __future__ import annotations

import torch

from lgm_tpu_torch.ops.gsplat.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    Projected,
    project_gaussians,
)


def composite_depth_sorted(proj: Projected, image_size: int,
                           chunk: int = 512):
    """Front-to-back composite of depth-sorted screen Gaussians over the
    full image. Returns (rgb [S, S, 3], alpha [S, S], depth [S, S],
    T [S, S]); ``depth`` is the alpha-weighted sum of camera-space z."""
    S = image_size
    dev = proj.mean2d.device
    active = proj.valid & (proj.radius > 0)
    keys = torch.where(active, proj.depth,
                       torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(keys, stable=True)
    mean2d, conic = proj.mean2d[order], proj.conic[order]
    color, opacity = proj.color[order], proj.opacity[order]
    zdepth, active = proj.depth[order], active[order]

    px = torch.arange(S, dtype=torch.float32, device=dev)
    pys, pxs = torch.meshgrid(px, px, indexing="ij")
    pxs, pys = pxs.reshape(-1), pys.reshape(-1)

    P = S * S
    T = torch.ones(P, device=dev)
    rgb = torch.zeros(P, 3, device=dev)
    acc_a = torch.zeros(P, device=dev)
    acc_d = torch.zeros(P, device=dev)
    for c0 in range(0, mean2d.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        dx = pxs[None, :] - mean2d[sl, 0:1]
        dy = pys[None, :] - mean2d[sl, 1:2]
        cn = conic[sl]
        power = (-0.5 * (cn[:, 0:1] * dx * dx + cn[:, 2:3] * dy * dy)
                 - cn[:, 1:2] * dx * dy)
        alpha = torch.clamp(opacity[sl, None] * torch.exp(power),
                            max=ALPHA_MAX)
        use = active[sl, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = torch.where(use, alpha, torch.zeros_like(alpha))
        cp = torch.cumprod(1.0 - alpha, dim=0)
        t_excl = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
        w = alpha * t_excl * T[None, :]
        rgb = rgb + w.T @ color[sl]
        acc_a = acc_a + w.sum(dim=0)
        acc_d = acc_d + (w * zdepth[sl, None]).sum(dim=0)
        T = T * cp[-1]
    return (rgb.reshape(S, S, 3), acc_a.reshape(S, S),
            acc_d.reshape(S, S), T.reshape(S, S))


def render_reference(gaussians: torch.Tensor, view: torch.Tensor,
                     image_size: int, tan_half_fov: float,
                     bg_color: torch.Tensor, scale_modifier: float = 1.0,
                     chunk: int = 512):
    """Render one view of packed Gaussians [N, 14]: dict of ``image``
    [S, S, 3] (bg-composited, unclamped), ``alpha`` and ``depth`` [S, S]."""
    proj = project_gaussians(gaussians, view, image_size, tan_half_fov,
                             scale_modifier)
    rgb, alpha, depth, T = composite_depth_sorted(proj, image_size, chunk)
    image = rgb + T[..., None] * bg_color[None, None, :]
    return {"image": image, "alpha": alpha, "depth": depth}
