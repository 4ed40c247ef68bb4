"""LPIPS perceptual loss (VGG-16 backbone) in PyTorch.

Port of ``lgm_tpu/models/lpips.py`` (ref: core/models.py:46-49,156-163): a
frozen feature extractor. The VGG-16 conv tower taps the activations after
each stage (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3); each tap is
unit-normalised over channels in f32 (eps 1e-10 under the root), the
squared difference of the two inputs' taps is weighted per channel by a
non-negative head ``|lin{k}|``, averaged over space and summed over taps.

Weights: ``load_lpips_params`` reads the ``.npz`` that
``lgm_tpu/tools/convert_lpips.py`` writes (Flax names, HWIO kernels);
``lpips_state_from_torch`` maps the released checkpoints' canonical names
(torchvision ``features.{i}`` and ``lin{k}.model.1.weight``) for
``load_lpips_state``. Without either, the tower starts from flax's
initialisers drawn from the caller's generator (``models/init.py``: as
lgm_tpu's tower, which sets none) and the heads hold 1/C, as lgm_tpu's
deterministic init does (a random-VGG perceptual surrogate; not the
released metric).

Inputs are NHWC RGB in [-1, 1], as lgm_tpu's. The convs run in ``dtype``
(bf16 in training) with f32 parameters; shift/scale and the tap
normalisation run in f32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lgm_tpu_torch.models.init import init_like_flax_

# Channel normalisation of the standard LPIPS scaling layer.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG-16 conv plan: (num_convs, channels) per stage; tap after each stage.
STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# torchvision vgg16 ``features`` conv indices per stage.
VGG16_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


class LPIPS(nn.Module):
    """``lpips(a, b)`` -> [B] distance; a, b [B, H, W, 3] in [-1, 1].

    Parameters ``vgg.conv{s}_{c}.weight/bias`` (OIHW) and ``lin{k}`` [C].
    ``stages`` keeps VGG-16's structure at other widths (the golden
    fixture's reduced tower). Frozen: no parameter requires grad. Given a
    ``generator``, the convs start from flax's initialisers; without one,
    from PyTorch's, for weights that are loaded next."""

    def __init__(self, stages=STAGES, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stages = tuple(tuple(s) for s in stages)
        self.dtype = dtype
        self.vgg = nn.ModuleDict()
        cin = 3
        for si, (n_convs, ch) in enumerate(self.stages):
            for ci in range(n_convs):
                self.vgg[f"conv{si}_{ci}"] = nn.Conv2d(cin, ch, 3, padding=1)
                cin = ch
            self.register_parameter(
                f"lin{si}", nn.Parameter(torch.full((ch,), 1.0 / ch)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        if generator is not None:
            init_like_flax_(self.vgg, generator)
        self.requires_grad_(False)

    def features(self, x: torch.Tensor):
        """NCHW f32 scaled input -> the per-stage taps (NCHW, ``dtype``)."""
        taps = []
        for si, (n_convs, _) in enumerate(self.stages):
            for ci in range(n_convs):
                conv = self.vgg[f"conv{si}_{ci}"]
                x = F.relu(F.conv2d(x.to(self.dtype),
                                    conv.weight.to(self.dtype),
                                    conv.bias.to(self.dtype), padding=1))
            taps.append(x)
            if si < len(self.stages) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        def prep(x):  # NHWC [-1, 1] -> scaled NCHW f32
            return (x.permute(0, 3, 1, 2).float() - self.shift) / self.scale

        total = 0.0
        for si, (xa, xb) in enumerate(zip(self.features(prep(a)),
                                          self.features(prep(b)))):
            xa, xb = xa.float(), xb.float()
            na = xa / torch.sqrt((xa * xa).sum(dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt((xb * xb).sum(dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{si}").abs().view(1, -1, 1, 1)
            contrib = ((na - nb) ** 2 * w).sum(dim=1)           # [B, H, W]
            total = total + contrib.mean(dim=(1, 2))
        return total


def load_lpips_params(model: LPIPS, npz_path: str) -> None:
    """Load the converted ``.npz`` (``lgm_tpu/tools/convert_lpips.py``:
    ``vgg/conv{s}_{c}/kernel`` HWIO, ``.../bias``, ``lin{k}``) into
    ``model``. Missing keys keep their values; an unknown key or a shape
    mismatch raises."""
    loaded = np.load(npz_path)
    sd = {}
    for key in loaded.files:
        arr = loaded[key]
        parts = key.split("/")
        if parts[0] == "vgg" and len(parts) == 3:
            leaf = {"kernel": "weight", "bias": "bias"}[parts[2]]
            if leaf == "weight":
                arr = arr.transpose(3, 2, 0, 1)
            sd[f"vgg.{parts[1]}.{leaf}"] = arr
        else:
            sd[key] = arr
    load_lpips_state(model, sd)


def lpips_state_from_torch(sd: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """Canonical torch names (torchvision ``features.{i}.weight/bias``,
    ``lin{k}.model.1.weight`` [1, C, 1, 1], or ``lins.{k}.…``), each
    optionally under ``net.``, ``vgg.`` or ``module.`` as
    ``lgm_tpu/tools/convert_lpips.py`` takes them -> this module's
    state-dict names."""
    def get(name):
        for prefix in ("", "net.", "vgg.", "module."):
            if prefix + name in sd:
                return sd[prefix + name]
        return None

    out: Dict[str, np.ndarray] = {}
    for si, idxs in enumerate(VGG16_CONV_IDX):
        for ci, idx in enumerate(idxs):
            for leaf in ("weight", "bias"):
                val = get(f"features.{idx}.{leaf}")
                if val is not None:
                    out[f"vgg.conv{si}_{ci}.{leaf}"] = np.asarray(
                        val, np.float32)
    for k in range(len(VGG16_CONV_IDX)):
        val = get(f"lin{k}.model.1.weight")
        if val is None:
            val = get(f"lins.{k}.model.1.weight")
        if val is not None:
            out[f"lin{k}"] = np.asarray(val, np.float32).reshape(-1)
    return out


def load_lpips_state(model: LPIPS, sd: Mapping[str, np.ndarray]) -> None:
    """Copy the given entries of this module's state dict into ``model``;
    missing keys keep their values, unknown keys and shape mismatches
    raise."""
    own = model.state_dict()
    for key, val in sd.items():
        if key not in own:
            raise KeyError(f"LPIPS key {key!r} not in the module")
        if tuple(val.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)} != "
                             f"{tuple(own[key].shape)}")
    with torch.no_grad():
        for key, val in sd.items():
            own[key].copy_(torch.as_tensor(np.asarray(val)))
