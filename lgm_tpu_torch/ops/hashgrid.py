"""Instant-NGP multiresolution hash-grid encoder (plain PyTorch).

Port of ``lgm_tpu/ops/hashgrid.py``, the encoder of the mesh converter's
NeRF distillation (ref: convert.py:92-93). Per level: the 8 corners of the
query's cell, their table rows gathered and weighted trilinearly; the
output is level-major with the features inner. Levels whose dense size
fits the table are indexed densely, finer levels by the xor-prime spatial
hash. The gradient reaches the table (a scatter-add of the gathers) and
the query points, through the trilinear weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_PRIMES = (1, 2654435761, 805459861)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: min(max(x, 0), 1), whose
    gradient is split in half where x sits on a bound (``torch.clamp``
    passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


class HashGridEncoder(nn.Module):
    """x in [0, 1]^3 [N, 3] -> [N, num_levels * features] encoding.

    Levels are geometric: resolution_l = floor(base * growth^l), computed
    in float64 as lgm_tpu does. ``table`` [L, T, F] starts uniform in
    ±1e-4 (drawn from ``generator`` where given)."""

    def __init__(self, num_levels: int = 12, features: int = 2,
                 log2_table_size: int = 19, base_resolution: int = 16,
                 max_resolution: int = 2048,
                 generator: torch.Generator = None):
        super().__init__()
        self.num_levels = num_levels
        self.features = features
        self.log2_table_size = log2_table_size
        self.base_resolution = base_resolution
        self.max_resolution = max_resolution
        T = 1 << log2_table_size
        table = torch.empty(num_levels, T, features)
        table.uniform_(-1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)

    def resolutions(self) -> np.ndarray:
        growth = np.exp(
            (np.log(self.max_resolution) - np.log(self.base_resolution))
            / max(self.num_levels - 1, 1)
        )
        return np.floor(
            self.base_resolution * growth ** np.arange(self.num_levels)
        ).astype(np.int64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = 1 << self.log2_table_size
        step = torch.arange(2, device=x.device)[:, None]         # [2, 1]
        outs = []
        for level, r in enumerate(self.resolutions()):
            r = int(r)
            pos = clip01(x) * (r - 1)
            p0 = torch.floor(pos)
            w = pos - p0                                         # [N, 3]
            # Per axis, the cell's two corner coordinates and weights [2, N];
            # the 8 corners are their outer combination [2, 2, 2, N] in
            # lgm_tpu's order (x outermost).
            p0 = p0.to(torch.int64).T
            cx, cy, cz = torch.clamp_max(p0[:, None] + step, r - 1)
            wx, wy, wz = (torch.stack([1.0 - w[:, a], w[:, a]])
                          for a in range(3))
            if (r + 1) ** 3 <= T:
                idx = ((cx[:, None, None] * r + cy[None, :, None]) * r
                       + cz[None, None, :])
            else:
                # lgm_tpu multiplies in uint32 with wrap-around; the int64
                # products stay below 2^43 here, and since T divides 2^32
                # their xor's low bits are the wrapped products' xor's.
                idx = ((cx * _PRIMES[0])[:, None, None]
                       ^ (cy * _PRIMES[1])[None, :, None]
                       ^ (cz * _PRIMES[2])[None, None, :]) & (T - 1)
            wc = (wx[:, None, None] * wy[None, :, None]
                  * wz[None, None, :]).reshape(8, -1)            # [8, N]
            # index_select: its gradient is one index_add_ into the table.
            g = self.table[level].index_select(0, idx.reshape(-1)).reshape(
                8, -1, self.features)                            # [8, N, F]
            outs.append(torch.sum(g * wc[..., None], dim=0))     # [N, F]
        return torch.cat(outs, dim=-1)

    @staticmethod
    def tv_loss(table: torch.Tensor) -> torch.Tensor:
        """Cheap total-variation surrogate on table entries (the CUDA
        grad_total_variation operates on spatial neighbors; collisions
        make exact spatial TV meaningless on hashed levels)."""
        return torch.mean(torch.square(table[:, 1:] - table[:, :-1]))
