"""Public rendering API: every (batch, view) pair of a [B, V] camera grid.

Port of ``lgm_tpu/ops/gsplat/api.py::render_views``. The default backend
is flatsort: on a CUDA tensor its composite is kernel K2, on a CPU tensor
the plain composite. ``backend="reference"`` selects the exact full-image
oracle (``reference.py``), for tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from lgm_tpu_torch.ops.gsplat.flatsort import (render_views_flatsort,
                                                stack_views)
from lgm_tpu_torch.ops.gsplat.reference import render_reference


def render_views(
    gaussians: torch.Tensor,
    cam_view: torch.Tensor,
    image_size: int,
    tan_half_fov: float,
    bg_color: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    backend: str = "flatsort",
    with_depth: bool = True,
    tile_h: int = 32,
    tile_w: int = 32,
    max_per_tile: int = 1024,
    dup: int = 16,
):
    """Render [B, V] views of per-scene Gaussians.

    Args:
      gaussians: [B, N, 14] packed activated Gaussians.
      cam_view: [B, V, 4, 4] transposed w2c matrices (reference layout).
      image_size: output resolution S (square).
      tan_half_fov: tan(fovy / 2).
      bg_color: [3] or [B, V, 3] background; white by default.
      scale_modifier: multiplier on Gaussian scales.
      backend: "flatsort" or "reference".
      with_depth: emit the accumulated-depth channel.
      tile_h, tile_w, max_per_tile, dup: flatsort tiling, per-tile cap and
        per-splat live-tile cap (the oracle ignores them).

    Returns dict of ``image`` [B, V, S, S, 3] clamped to [0, 1], ``alpha``
    [B, V, S, S, 1] and, with depth, ``depth`` [B, V, S, S, 1] (NHWC).
    """
    B, V = cam_view.shape[:2]
    dev = gaussians.device
    if bg_color is None:
        bg_color = torch.ones(3, device=dev)
    bg = torch.broadcast_to(bg_color.to(dev, torch.float32), (B, V, 3))

    if backend == "flatsort":
        out = render_views_flatsort(
            gaussians, cam_view, image_size, tan_half_fov, bg,
            scale_modifier, tile_h, tile_w, dup, max_per_tile, with_depth)
    elif backend == "reference":
        views = [render_reference(gaussians[b], cam_view[b, v], image_size,
                                  tan_half_fov, bg[b, v], scale_modifier)
                 for b in range(B) for v in range(V)]
        out = stack_views(views, B, V)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    result = {"image": torch.clamp(out["image"], 0.0, 1.0),
              "alpha": out["alpha"][..., None]}
    if with_depth:
        result["depth"] = out["depth"][..., None]
    return result
