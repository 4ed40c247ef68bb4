"""Model weights: reference torch state dicts and Flax parameter trees.

The port's modules carry the reference torch state-dict names
(``unet.down_blocks.{i}.nets.{j}.conv1.weight``, ``conv.weight``, ...),
so a reference checkpoint (``.safetensors`` or ``.pt``) loads with
``load_state_dict`` as it is: ``load_reference_weights`` is ``--resume``
for the port. ``flax_params_to_state_dict`` is the inverse of
``lgm_tpu/tools/convert_weights.py``: it turns an ``lgm_tpu`` Flax LGM
parameter tree (numpy leaves) into that state dict — conv HWIO -> OIHW,
dense [in, out] -> [out, in], GroupNorm ``scale`` -> ``weight``. Given the
whole ``LGMWithLoss`` tree (``lgm/...`` and ``lpips_loss/m/...``) it
returns the state dict of the port's ``LGMWithLoss``: ``lgm.*`` as above,
``lpips_loss.vgg.conv{s}_{c}.*`` and ``lpips_loss.lin{k}``.

Orbax checkpoints written by ``lgm_tpu.train`` need JAX to read and are
not loaded here.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = {"down": "down_blocks", "up": "up_blocks"}


def _torch_module_path(path) -> str:
    """Flax module path (no leaf) -> torch module name."""
    out = []
    for p in path:
        m = re.fullmatch(r"(down|up|res|attn)(\d+)", p)
        if m and m[1] in _BLOCK:
            out += [_BLOCK[m[1]], m[2]]
        elif m:
            out += ["nets" if m[1] == "res" else "attns", m[2]]
        elif p == "mid":
            out.append("mid_block")
        elif p in ("qkv", "proj"):
            out += ["attn", p]
        elif p == "down":
            out.append("downsample")
        elif p == "up":
            out.append("upsample")
        else:  # unet, conv, conv_in, norm_out, conv_out, norm*, conv*,
            out.append(p)  # shortcut
    return ".".join(out)


def _lpips_state_dict(m: Mapping) -> Dict[str, np.ndarray]:
    """lgm_tpu LPIPS params (``vgg/conv{s}_{c}/{kernel,bias}``,
    ``lin{k}``) -> the port's LPIPS state dict."""
    sd: Dict[str, np.ndarray] = {}
    for name, conv in m["vgg"].items():
        sd[f"vgg.{name}.weight"] = np.ascontiguousarray(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1))
        sd[f"vgg.{name}.bias"] = np.array(conv["bias"], np.float32)
    for name, val in m.items():
        if name != "vgg":
            sd[name] = np.array(val, np.float32)
    return sd


def flax_params_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``lgm_tpu`` LGM params (``{"unet": ..., "conv": ...}``) or
    ``LGMWithLoss`` params (``{"lgm": ..., "lpips_loss": ...}``), either
    optionally under ``"params"`` -> the port's state dict of numpy
    arrays (the reference torch names for the LGM)."""
    if "params" in params:
        params = params["params"]
    if "lgm" in params:
        sd = {f"lgm.{k}": v
              for k, v in flax_params_to_state_dict(params["lgm"]).items()}
        if "lpips_loss" in params:
            sd.update({f"lpips_loss.{k}": v for k, v in _lpips_state_dict(
                params["lpips_loss"]["m"]).items()})
        return sd
    sd: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.array(val, np.float32)  # a writable copy
            if key == "kernel":
                arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                       else arr.T)
                leaf = "weight"
            elif key == "scale":
                leaf = "weight"
            elif key == "bias":
                leaf = "bias"
            else:
                raise KeyError(f"unexpected Flax leaf {path + (key,)}")
            sd[f"{_torch_module_path(path)}.{leaf}"] = np.ascontiguousarray(
                arr)

    walk(params, ())
    return sd


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read an LGM state dict: a reference-format one (``.safetensors`` or
    a torch ``.pt``/``.pth``, optionally under a ``"model"`` key), or a
    training checkpoint of ``lgm_tpu_torch.train`` (``save_checkpoint``'s
    ``ckpt_N``: ``LGMWithLoss``'s state dict under ``"params"``, whose
    ``lgm.*`` keys are LGM's and keep their names without the prefix; the
    counterpart of ``lgm_tpu/infer.py``'s ``restored["params"]["lgm"]``).
    LPIPS weights, which both may carry, are dropped."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "params" in sd:
            sd = {k[len("lgm."):]: v for k, v in sd["params"].items()
                  if k.startswith("lgm.")}
        elif isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
    return {k: v.float() for k, v in sd.items() if "lpips" not in k}


def load_state_dict_into(model: torch.nn.Module,
                         sd: Mapping[str, object]) -> None:
    """Strict load of a state dict of numpy arrays or tensors."""
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                          strict=True)


def load_reference_weights(model: torch.nn.Module, path: str) -> None:
    """``--resume``: load a reference checkpoint file into ``model``."""
    load_state_dict_into(model, load_state_dict_file(path))
