"""Convert torch LPIPS(VGG-16) weights to the ``.npz`` both packages load.

The reference scores training renders with the VGG LPIPS metric, two
torch state dicts glued together: the torchvision ``vgg16`` backbone
(``features.{i}.weight/bias``) and the LPIPS linear heads
(``lin{k}.model.1.weight``, [1, C_k, 1, 1]). This is the port's
counterpart of ``lgm_tpu/tools/convert_lpips.py``, with its command line
and its output: a flat ``.npz`` of Flax names,

  features.{idx}.weight  -> vgg/conv{si}_{ci}/kernel   (OIHW -> HWIO)
  features.{idx}.bias    -> vgg/conv{si}_{ci}/bias
  lin{k}.model.1.weight  -> lin{k}                     ([1,C,1,1] -> [C])

which ``models/lpips.load_lpips_params`` (``--lpips-weights`` of the
port's trainer) and lgm_tpu's loader both read. The names are mapped by
``models/lpips.lpips_state_from_torch``; no torchvision and no network.

Usage:
  python -m lgm_tpu_torch.tools.convert_lpips vgg16.pth lpips_vgg.pth out.npz
  (either input may be '' to convert the other alone)
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from lgm_tpu_torch.models.lpips import lpips_state_from_torch


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` or torch ``.pth`` state dict (optionally under
    ``"state_dict"``) as numpy arrays."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def to_flax_names(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The port's LPIPS state-dict names -> the ``.npz``'s Flax names."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if key.startswith("vgg."):
            _, conv, leaf = key.split(".")
            if leaf == "weight":
                out[f"vgg/{conv}/kernel"] = np.ascontiguousarray(
                    val.transpose(2, 3, 1, 0))
            else:
                out[f"vgg/{conv}/bias"] = val
        else:
            out[key] = val
    return out


def convert(vgg_path: str, lpips_path: str, out_path: str) -> int:
    merged: Dict[str, np.ndarray] = {}
    for path in (vgg_path, lpips_path):
        if path:
            merged.update(to_flax_names(lpips_state_from_torch(
                _load_state_dict(path))))
    np.savez(out_path, **merged)
    return len(merged)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("vgg", help="torchvision vgg16 state dict (.pth), "
                    "or '' to skip")
    ap.add_argument("lpips", help="LPIPS lin-head state dict (.pth), "
                    "or '' to skip")
    ap.add_argument("out", help="output .npz")
    args = ap.parse_args(argv)
    n = convert(args.vgg, args.lpips, args.out)
    print(f"wrote {n} arrays -> {args.out}")


if __name__ == "__main__":
    main()
