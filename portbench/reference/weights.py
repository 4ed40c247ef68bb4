"""Seeded random weights, made on the device in one draw.

The benchmark hands the same f32 tensors to the program (``load_state_dict``)
and to the plain references. One ``torch.randn`` of every weight at once
from a generator on the card, then each weight scaled by its kind:

- a convolution or dense kernel: std 1/sqrt(fan_in), so activations keep
  their scale through the layers (flax's lecun-normal, untruncated);
- a GroupNorm scale: 1 + 0.1 n; any other bias: 0.02 n;
- an LPIPS head ``lin{k}``: |n| / C, non-negative as the released heads;
- the named overrides of a configuration's ``assumed.init`` (the LGM's
  last 1x1 convolution, which sets the size and spread of the Gaussians):
  ``{"std": s}`` or ``{"mean": [...], "std": s}`` per weight.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


@torch.no_grad()
def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         overrides: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    overrides = overrides or {}
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        w = flat[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if name in overrides:
            rule = overrides[name]
            w.mul_(rule["std"])
            if "mean" in rule:
                mean = torch.tensor(rule["mean"], device=device)
                w.add_(mean.view((-1,) + (1,) * (len(shape) - 1)))
        elif len(shape) >= 2:
            w.mul_((n // shape[0]) ** -0.5)
        elif leaf.startswith("lin"):
            w.abs_().div_(shape[0])
        elif ".norm" in name and leaf == "weight":
            w.mul_(0.1).add_(1.0)
        else:
            w.mul_(0.02)
        out[name] = w
    return out
