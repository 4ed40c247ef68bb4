"""Flax's default initialisers for the port's modules.

``lgm_tpu``'s models set no ``kernel_init``, so every ``nn.Conv`` and
``nn.Dense`` there starts from flax's defaults: the kernel is
``lecun_normal`` (``variance_scaling(1.0, "fan_in", "truncated_normal")``:
a normal truncated at ±2σ, rescaled so its variance is 1/fan_in) and the
bias is zero. PyTorch's defaults differ (kaiming-uniform kernels of
variance 1/(3·fan_in), uniform biases), and a model trained from them
learns more slowly than ``lgm_tpu``'s (ROADMAP C7). ``init_like_flax_``
gives a module flax's initialisers, drawn from an explicit generator.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# The standard deviation of a unit normal truncated at ±2: jax's
# variance_scaling divides by it so the truncated draw has the variance
# asked for.
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator
                    ) -> nn.Module:
    """Redraw every ``nn.Conv2d`` and ``nn.Linear`` under ``module``, in
    ``modules()`` order, as flax initialises them: the weight from a
    normal of σ = sqrt(1/fan_in) / 0.8796 truncated at ±2σ (fan_in =
    in_channels / groups × kh × kw for a conv, in_features for a dense),
    the bias zero. The draws come from ``generator`` on its own device and
    are then copied to the parameter's, so a generator seed gives the same
    weights wherever the module lives. Other parameters (GroupNorm's ones
    and zeros) are left as they are."""
    for m in module.modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear)):
            continue
        std = (1.0 / m.weight[0].numel()) ** 0.5 / TRUNC_STD
        w = torch.empty(m.weight.shape, device=generator.device)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        m.weight.copy_(w)
        if m.bias is not None:
            m.bias.zero_()
    return module
