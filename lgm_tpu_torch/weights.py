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

``diffusion_params_to_state_dicts`` does the same for ``lgm_tpu``'s
diffusion pipeline tree (``unet``, ``vae``, ``text_encoder``,
``image_encoder``): it inverts ``lgm_tpu/tools/convert_diffusion.py``'s
name maps (reference MVDream U-Net names, diffusers' VAE names) and
transformers' Flax CLIP names, giving the state dicts of the port's
``diffusion`` modules.

``lgm_train_state_to_torch`` turns ``lgm_tpu.train``'s state (the
parameters, the optax chain's state, the step) into the port's
``train.save_checkpoint`` dict; ``diffusion_train_state_to_torch`` turns
``lgm_tpu``'s diffusion finetune state (parameters, Adam's moments, the EMA) into the port's
trainer state, through the same U-Net name map.

``nerf_params_to_torch`` maps the mesh converter's Flax NeRF field
(``grid/table``, ``mlp1``, ``mlp2``) into the state dict of the port's
``convert.NerfField``.

Orbax checkpoints written by ``lgm_tpu`` need JAX to read and are not
loaded here: ``scripts/ckpt_to_torch.py`` converts a trainer's ``ckpt_N``,
``scripts/dckpt_to_torch.py`` a finetune's ``dckpt_N`` and
``scripts/pipeline_to_torch.py`` a pipeline directory.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence

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
    return _tree_to_state_dict(params, _torch_module_path)


_LGM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_DIFFUSION_LEAVES = dict(_LGM_LEAVES, embedding="weight")


def _tree_to_state_dict(tree: Mapping, module_name, leaves=_LGM_LEAVES,
                        bare=()) -> Dict[str, np.ndarray]:
    """Walk a Flax tree: each leaf named in ``leaves`` becomes that torch
    leaf of ``module_name(path)`` (a kernel transposed to torch's layout);
    each in ``bare`` is a bare parameter that keeps its name; any other
    leaf is an error."""
    sd: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.array(val, np.float32)  # a writable copy
            if key in bare:
                name = module_name(path + (key,))
            elif key in leaves:
                if key == "kernel":
                    arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                           else arr.T)
                name = f"{module_name(path)}.{leaves[key]}"
            else:
                raise KeyError(f"unexpected Flax leaf {path + (key,)}")
            sd[name] = np.ascontiguousarray(arr)

    walk(tree, ())
    return sd


_RES_NAMES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
              "emb_1": "emb_layers.1", "out_norm": "out_layers.0",
              "out_conv": "out_layers.3", "skip": "skip_connection"}


def _attn_inner_name(rest) -> str:
    """The inside of a SpatialTransformer3D: Flax path -> torch name."""
    out = []
    for p in rest:
        m = re.fullmatch(r"transformer_blocks_(\d+)", p)
        if m:
            out += ["transformer_blocks", m[1]]
        elif p == "to_out_0":
            out += ["to_out", "0"]
        elif p == "net_0":
            out += ["net", "0"]
        elif p == "net_2":
            out += ["net", "2"]
        else:
            out.append(p)
    return ".".join(out)


def _unet_module_name(path, tree: Mapping) -> str:
    """Inverse of ``convert_diffusion.unet_torch_to_flax``."""
    head, rest = path[0], path[1:]
    fixed = {"time_embed_0": "time_embed.0", "time_embed_2": "time_embed.2",
             "camera_embed_0": "camera_embed.0",
             "camera_embed_2": "camera_embed.2", "out_norm": "out.0",
             "out_conv": "out.2", "input_conv": "input_blocks.0.0"}
    if head in fixed:
        return fixed[head]
    if head == "image_embed":
        sub = rest[0]
        m = re.fullmatch(r"layers_(\d+)_(attn|ff_norm|ff_1|ff_3)", sub)
        if not m:
            return "image_embed." + sub
        tail = {"attn": "0", "ff_norm": "1.0", "ff_1": "1.1",
                "ff_3": "1.3"}[m[2]]
        return ".".join(["image_embed.layers", m[1], tail] + list(rest[1:]))
    m = re.fullmatch(r"(in|out|mid)(\d+)_(res|attn|down|up)|mid_(res\d|attn)",
                     head)
    if m is None:
        raise KeyError(f"unexpected U-Net module {path}")
    if m[4]:  # mid_res0, mid_attn, mid_res1
        idx = {"res0": 0, "attn": 1, "res1": 2}[m[4]]
        kind = "attn" if m[4] == "attn" else "res"
        block = f"middle_block.{idx}"
    else:
        side = "input_blocks" if m[1] == "in" else "output_blocks"
        kind = m[3]
        if kind in ("res", "down"):
            idx = 0
        elif kind == "attn":
            idx = 1
        else:  # an output block's Upsample follows its attention, if any
            idx = 2 if f"out{m[2]}_attn" in tree else 1
        block = f"{side}.{m[2]}.{idx}"
    if kind == "res":
        return f"{block}.{_RES_NAMES[rest[0]]}"
    if kind == "attn":
        return f"{block}.{_attn_inner_name(rest)}"
    return f"{block}.{rest[0]}"  # down: op; up: conv


def _vae_module_name(path) -> str:
    """Inverse of ``convert_diffusion.vae_torch_to_flax``."""
    side, head, rest = path[0], path[1], path[2:]
    if head in ("quant_conv", "post_quant_conv"):
        return head
    m = re.fullmatch(r"(down|up|mid)(\d*)_(res\d+|downsample|upsample|attn)",
                     head)
    if m is None:
        return ".".join((side, head) + tuple(rest))
    if m[1] == "mid":
        block = f"{side}.mid_block"
    else:
        block = f"{side}.{m[1]}_blocks.{m[2]}"
    if m[3] in ("downsample", "upsample"):
        return f"{block}.{m[3]}rs.0.conv"
    if m[3] == "attn":
        return f"{block}.attentions.0.{_attn_inner_name(rest)}"
    return f"{block}.resnets.{m[3][3:]}.{'.'.join(rest)}"


def diffusion_params_to_state_dicts(params: Mapping) -> Dict[str, Dict]:
    """``lgm_tpu``'s diffusion pipeline tree (numpy leaves: ``unet``,
    ``vae``, ``text_encoder``, ``image_encoder``, whichever are present)
    -> the port's state dicts under the same keys: the reference MVDream
    U-Net names, diffusers' VAE names, transformers' CLIP names."""
    out: Dict[str, Dict] = {}
    for comp, tree in params.items():
        if comp == "unet":  # the Resampler's latents are bare
            out[comp] = _tree_to_state_dict(
                tree, lambda p, t=tree: _unet_module_name(p, t),
                bare=("latents",))
        elif comp == "vae":
            out[comp] = _tree_to_state_dict(tree, _vae_module_name)
        elif comp in ("text_encoder", "image_encoder"):
            # CLIP's token and position embeddings; the vision tower's
            # class embedding is bare
            out[comp] = _tree_to_state_dict(tree, ".".join, _DIFFUSION_LEAVES,
                                            bare=("class_embedding",))
        else:
            raise KeyError(f"unknown pipeline component {comp!r}")
    return out


def _adam_state(tree):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    children = (tree.values() if isinstance(tree, Mapping) else
                tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def lgm_train_state_to_torch(state: Mapping, names: Sequence[str]) -> Dict:
    """``lgm_tpu.train``'s state (numpy trees ``{"params", "opt_state",
    "step"}``: ``LGMWithLoss``'s parameters; optax's ``multi_transform``
    of the clip and ``adamw`` over the LGM, ``set_to_zero`` over LPIPS,
    wrapped in ``MultiSteps`` under gradient accumulation) -> the port's
    ``train.save_checkpoint`` dict: the parameters under the port's
    ``LGMWithLoss`` names, and ``train.Optimizer``'s state with Adam's
    count, its bf16 first moment (ROADMAP C4: kept in bf16, as optax keeps
    it), its f32 second moment and, under accumulation, the mini-step and
    the running mean of the gradients, each a list in the order of
    ``names``, the port's LGM parameter names (``LGM.named_parameters``)."""
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise KeyError("no Adam state (mu, nu) in opt_state")

    def lgm_list(tree: Mapping, dtype) -> List[torch.Tensor]:
        sd = flax_params_to_state_dict({"lgm": tree["lgm"]})
        missing = sorted(set(f"lgm.{n}" for n in names) ^ set(sd))
        if missing:
            raise KeyError(f"parameter names differ: {missing[:4]}")
        return [torch.as_tensor(sd[f"lgm.{n}"]).to(dtype) for n in names]

    opt_state = {"count": int(np.asarray(adam.count)),
                 "mu": lgm_list(adam.mu, torch.bfloat16),
                 "nu": lgm_list(adam.nu, torch.float32),
                 "mini_step": 0, "acc": None}
    multi = state["opt_state"]
    if hasattr(multi, "acc_grads"):  # optax.MultiSteps' state
        opt_state["mini_step"] = int(np.asarray(multi.mini_step))
        opt_state["acc"] = lgm_list(multi.acc_grads, torch.float32)
    return {"params": {k: torch.as_tensor(v) for k, v in
                       flax_params_to_state_dict(state["params"]).items()},
            "opt_state": opt_state,
            "step": int(np.asarray(state["step"]))}


def _unet_tensors(tree: Mapping, dtype=torch.float32) -> Dict:
    return {k: torch.as_tensor(v).to(dtype) for k, v in
            diffusion_params_to_state_dicts({"unet": tree})["unet"].items()}


def diffusion_train_state_to_torch(state: Mapping) -> Dict:
    """``lgm_tpu.diffusion.train``'s finetune state (numpy trees
    ``{"unet", "opt_state", "step"}`` and ``"ema"`` where it keeps one;
    ``opt_state`` optax's ``(ClipByGlobalNormState, (ScaleByAdamState(count,
    mu, nu), EmptyState, ScaleByScheduleState))``) -> the port's
    ``DiffusionTrainer.state_dict()``: the U-Net's state dict, Adam's
    count, its bf16 first and f32 second moments and the EMA keyed by the
    port's parameter names (the U-Net name map of
    ``diffusion_params_to_state_dicts``)."""
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise KeyError("no Adam state (mu, nu) in opt_state")
    out = {"unet": _unet_tensors(state["unet"]),
           "opt_state": {"count": int(np.asarray(adam.count)),
                         "mu": _unet_tensors(adam.mu, torch.bfloat16),
                         "nu": _unet_tensors(adam.nu)},
           "step": int(np.asarray(state["step"]))}
    if state.get("ema") is not None:
        out["ema"] = _unet_tensors(state["ema"])
    return out


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


def nerf_params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """``lgm_tpu.convert``'s NeRF field parameters (``{"grid": {"table"},
    "mlp1": {"kernel", "bias"}, "mlp2": ...}``, numpy or JAX leaves) ->
    the state dict of ``lgm_tpu_torch.convert.NerfField``: the table as it
    is, each Dense ``kernel [in, out]`` as ``Linear.weight [out, in]``."""
    sd = {"grid.table": torch.tensor(np.asarray(params["grid"]["table"],
                                                np.float32))}
    for name in ("mlp1", "mlp2"):
        sd[f"{name}.weight"] = torch.tensor(
            np.asarray(params[name]["kernel"], np.float32).T.copy())
        sd[f"{name}.bias"] = torch.tensor(
            np.asarray(params[name]["bias"], np.float32))
    return sd
