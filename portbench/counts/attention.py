"""Operations and bytes of the attention kernels K1 (forward) and K1ᵇ
(backward) by shape, and the attention calls a model makes.

The bounds are copies of the kernel table's (the bring-up's
``chip_smoke.py``): K1 does 4 BH Sq Sk D tensor-core flops (Q.Kᵀ, P.V),
one exp and ~5 f32 operations a logit, and reads q, k, v and writes o and
the f32 row statistic once; K1ᵇ does 10 BH Sq Sk D (Q.Kᵀ, dO.Vᵀ, dS.K,
dSᵀ.Q, Pᵀ.dO), one exp and ~5 f32 operations a logit, reads q, o, dO, k,
v and the statistic and writes dq, dk, dv once, in bf16.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.counts.peaks import (BF16_TENSOR_FLOPS, F32_FLOPS,
                                    SFU_EXP_PER_S, bound_s)


def k1_bound_s(BH: int, Sq: int, Sk: int, D: int) -> float:
    return bound_s(
        {"tensor": 4.0 * BH * Sq * Sk * D / BF16_TENSOR_FLOPS,
         "exp": BH * Sq * Sk / SFU_EXP_PER_S,
         "f32": 5.0 * BH * Sq * Sk / F32_FLOPS},
        2 * BH * Sq * D * 2 + 2 * BH * Sk * D * 2 + BH * Sq * 4)


def k1b_bound_s(BH: int, Sq: int, Sk: int, D: int) -> float:
    return bound_s(
        {"tensor": 10.0 * BH * Sq * Sk * D / BF16_TENSOR_FLOPS,
         "exp": BH * Sq * Sk / SFU_EXP_PER_S,
         "f32": 5.0 * BH * Sq * Sk / F32_FLOPS},
        4 * BH * Sq * D * 2 + 2 * BH * Sk * D * 4 + BH * Sq * 4)


def lgm_sites(cfg: dict, batch: int) -> List[Tuple[int, int, int]]:
    """(BH, S, D) of each cross-view attention of one LGM forward over
    ``batch`` scenes: 16 heads over the V input views' tokens of every
    level that attends (down, mid, up)."""
    heads, views = 16, cfg["num_input_views"]
    res = cfg["input_size"]
    sites = []
    down = cfg["down_channels"]
    for i, ch in enumerate(down):
        if cfg["down_attention"][i]:
            sites += [(batch * heads, views * res * res, ch // heads)] * 2
        if i != len(down) - 1:
            res //= 2
    if cfg["mid_attention"]:
        sites.append((batch * heads, views * res * res, down[-1] // heads))
    for i, ch in enumerate(cfg["up_channels"]):
        if cfg["up_attention"][i]:
            sites += [(batch * heads, views * res * res, ch // heads)] * 3
        if i != len(cfg["up_channels"]) - 1:
            res *= 2
    return sites
