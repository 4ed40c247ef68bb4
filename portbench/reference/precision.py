"""Precision of the plain references.

The references compute in f32 with TF32 off. The control is the same
reference a step below each precision the configuration states: every
operand of the products the program takes in bf16 (convolutions, dense
layers, attention) rounded to fp8 e4m3, one scale a tensor (its largest
magnitude to e4m3's 448), and the renderer, which the program runs in
f32, in bf16.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

E4M3_MAX = 448.0


def full(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at a per-tensor scale, back in f32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # Straight-through: the rounding has no gradient of its own.
    return x + (q - x).detach()


class Precision(NamedTuple):
    q: Callable            # operand rounding of the program's bf16 products
    render: torch.dtype    # the renderer's arithmetic


PRECISIONS = {"fp32": Precision(full, torch.float32),
              "control": Precision(fp8, torch.bfloat16)}


def f32_only() -> None:
    """Full f32 products on the card (TF32 is a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
