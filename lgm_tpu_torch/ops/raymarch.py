"""Occupancy-grid ray marching + volume rendering (plain PyTorch).

Port of ``lgm_tpu/ops/raymarch.py``, the replacement for nerfacc's
OccGridEstimator sampling and render_weight_from_density compositing
(ref: convert.py:131-184): every ray takes a fixed number of stratified
samples inside its AABB interval, masked by a binary occupancy grid, with
the front-to-back weights w_i = (1 - exp(-sigma_i dt_i)) * T_i.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class OccupancyGrid(NamedTuple):
    """Binary occupancy over an AABB, resolution R^3."""

    occ: torch.Tensor       # [R, R, R] bool
    aabb_min: torch.Tensor  # [3]
    aabb_max: torch.Tensor  # [3]

    @staticmethod
    def dense(resolution: int = 64, aabb: float = 1.0,
              device="cpu") -> "OccupancyGrid":
        return OccupancyGrid(
            torch.ones((resolution,) * 3, dtype=torch.bool, device=device),
            torch.full((3,), -aabb, device=device),
            torch.full((3,), aabb, device=device),
        )

    def update(self, density_fn: Callable, threshold: float = 0.01,
               chunk: int = 1 << 16) -> "OccupancyGrid":
        """Re-evaluate occupancy at cell centers, ``chunk`` points a call
        to ``density_fn``, without gradient (ref: convert.py:140-146
        periodic update_every_n_steps)."""
        R = self.occ.shape[0]
        dev = self.occ.device
        g = (torch.arange(R, device=dev) + 0.5) / R
        X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
        pts = torch.stack([X, Y, Z], dim=-1).reshape(-1, 3)
        pts = self.aabb_min + pts * (self.aabb_max - self.aabb_min)
        with torch.no_grad():
            sig = torch.cat([density_fn(c) for c in pts.split(chunk)])
        return self._replace(occ=(sig > threshold).reshape(R, R, R))

    def query(self, pts: torch.Tensor) -> torch.Tensor:
        """Occupancy at world points [N, 3] (False outside the AABB)."""
        R = self.occ.shape[0]
        u = (pts - self.aabb_min) / (self.aabb_max - self.aabb_min)
        inside = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
        idx = torch.clamp((u * R).to(torch.int64), 0, R - 1)
        return inside & self.occ[idx[:, 0], idx[:, 1], idx[:, 2]]


def ray_aabb(rays_o, rays_d, aabb_min, aabb_max):
    """Entry/exit distances of rays into the AABB (clamped >= 0)."""
    inv = 1.0 / torch.where(torch.abs(rays_d) < 1e-9,
                            torch.sign(rays_d) * 1e-9 + 1e-12, rays_d)
    t0 = (aabb_min - rays_o) * inv
    t1 = (aabb_max - rays_o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    tmin = torch.clamp_min(tmin, 0.0)
    return tmin, torch.maximum(tmax, tmin)


def render_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    field_fn: Callable[[torch.Tensor, torch.Tensor],
                       Tuple[torch.Tensor, torch.Tensor]],
    grid: OccupancyGrid,
    num_samples: int = 128,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[torch.Tensor] = None,
):
    """Volume-render rays [N, 3] against a radiance field.

    ``field_fn(pts [M, 3], dirs [M, 3]) -> (sigma [M], rgb [M, 3])``.
    Training jitters the samples (stratified): ``jitter`` [N, S] uniform in
    [0, 1) where given, else drawn from ``generator`` where given; without
    either the samples sit at the stratum centres.
    Returns dict(rgb [N, 3], alpha [N], depth [N]).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    tmin, tmax = ray_aabb(rays_o, rays_d, grid.aabb_min, grid.aabb_max)
    span = (tmax - tmin) / num_samples
    frac = (torch.arange(num_samples, device=dev) + 0.5) / num_samples
    if jitter is None and generator is not None:
        jitter = torch.rand((N, num_samples), generator=generator,
                            device=generator.device).to(dev)
    if jitter is not None:  # stratified jitter during training
        frac = frac + (jitter - 0.5) / num_samples
    t = tmin[:, None] + frac * (tmax - tmin)[:, None]  # [N, S]
    pts = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]

    flat = pts.reshape(-1, 3)
    occ = grid.query(flat)
    sigma, rgb = field_fn(flat, torch.broadcast_to(
        rays_d[:, None, :], pts.shape).reshape(-1, 3))
    sigma = torch.where(occ, sigma, 0.0).reshape(N, num_samples)
    rgb = rgb.reshape(N, num_samples, 3)

    dt = span[:, None]
    alpha = 1.0 - torch.exp(-sigma * dt)  # [N, S]
    t_excl = torch.cat(
        [torch.ones_like(alpha[:, :1]),
         torch.cumprod(1.0 - alpha[:, :-1] + 1e-10, dim=1)], dim=1,
    )
    w = alpha * t_excl
    return {
        "rgb": torch.sum(w[..., None] * rgb, dim=1),
        "alpha": torch.sum(w, dim=1),
        "depth": torch.sum(w * t, dim=1),
    }
