"""Cross-view multi-head attention: kernel K1 and its plain version.

``mha_fwd`` is the port of ``lgm_tpu/ops/mha.py``'s K-resident forward
(``_fwd_kernel`` via ``_mha_fwd``): full unmasked attention over
``[BH, S, D]``, exact softmax (row max over all keys, no online
rescaling), P rounded to the input dtype before P.V, f32 accumulation,
output in the input dtype. On a CUDA tensor it launches the hand-written
kernel in ``csrc/mha_fwd.cu`` (bf16, D in {32, 64}, S a multiple of 64)
or raises; on a CPU tensor it runs ``mha_reference``, the same function
in plain PyTorch. The kernel's design note and bound are in its source.

The TPU kernel ran only at S >= 2048 (``lgm_tpu/models/unet.py:61-62``),
a VMEM/HBM choice of that chip; the port runs the kernel at every
MVAttention site, since the function is the same at each.

Forward only: the backward kernel (K1 backward, ``_mha_bwd``) arrives
with the training slice, so a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes

import torch

from lgm_tpu_torch.ops import _build

_SIGNATURES = {
    "mha_fwd_bf16": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_BLOCK_Q = 64  # query rows per block; S must be a multiple


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Plain version of K1: q/k/v [BH, S, D] -> [BH, S, D] in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / s
    return o.to(q.dtype)


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """K1 on a CUDA tensor, ``mha_reference`` on a CPU tensor."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd: unsupported device {q.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "mha_fwd is forward-only: its backward kernel arrives with the "
            "training slice (run under torch.inference_mode())")
    BH, S, D = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.shape != q.shape \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(
                f"mha_fwd: {name} must be a contiguous bf16 tensor of shape "
                f"{tuple(q.shape)} on {q.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if D not in (32, 64) or S % _BLOCK_Q:
        raise ValueError(
            f"mha_fwd kernel takes D in (32, 64) and S % {_BLOCK_Q} == 0, "
            f"got D={D}, S={S}")
    o = torch.empty_like(q)
    lib = _build.load("mha_fwd", _SIGNATURES)
    err = lib.mha_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, S, D,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        q.device.index)
    _build.check(lib, err, "mha_fwd")
    mha_fwd.launches += 1
    return o


mha_fwd.launches = 0
