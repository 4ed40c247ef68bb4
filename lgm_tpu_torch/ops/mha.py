"""Cross-view multi-head attention: kernels K1 and K1ᵇ and their plain
versions.

``mha_fwd`` is the port of ``lgm_tpu/ops/mha.py``'s K-resident forward
(``_fwd_kernel`` via ``_mha_fwd``): full unmasked attention over
``[BH, S, D]``, exact softmax (row max over all keys, no online
rescaling), P rounded to the input dtype before P.V, f32 accumulation,
output in the input dtype. On a CUDA tensor it launches the hand-written
kernel in ``csrc/mha_fwd.cu`` (bf16, D in {32, 64}, S a multiple of 64)
or raises; on a CPU tensor it runs ``mha_reference``, the same function
in plain PyTorch.

``mha_bwd`` is the port of the backward (``_bwd_kernel`` via
``_mha_bwd``): from the residuals q, k, v, o and the cotangent dO it
recomputes the exact normalized P, forms dS = P∘(dO·Vᵀ − rowsum(dO∘O))
with dO, dS and P rounded to the input dtype before their products, and
returns dq = dS·K·scale, dK = dSᵀ·Q·scale, dV = Pᵀ·dO in the input dtype.
On a CUDA tensor it launches ``csrc/mha_bwd.cu``; on a CPU tensor it runs
``mha_bwd_reference``. ``mha`` joins the two in an autograd Function,
saving q, k, v, o as ``_mha_fwd`` does. Each kernel's design note and
bound are in its source.

The TPU kernel ran only at S >= 2048 (``lgm_tpu/models/unet.py:61-62``),
a VMEM/HBM choice of that chip; the port runs the kernels at every
MVAttention site, since the function is the same at each.
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
_BWD_SIGNATURES = {
    "mha_bwd_bf16": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_BLOCK_Q = 64  # query (and key) rows per block; S must be a multiple


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Plain version of K1: q/k/v [BH, S, D] -> [BH, S, D] in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / s
    return o.to(q.dtype)


def mha_bwd_reference(q, k, v, o, do, scale: float):
    """Plain version of K1ᵇ: (dq, dk, dv), each [BH, S, D] in q's dtype.

    The arithmetic of ``lgm_tpu/ops/mha.py::_bwd_kernel``: P recomputed
    exactly and normalized in f32; dO, dS and P rounded to the input dtype
    before their products (bf16 on the card; no rounding at f32, where
    this is the exact softmax-attention backward); f32 accumulation."""
    dt = q.dtype
    qf, kf = q.float(), k.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dob = do.to(dt).float()
    dp = torch.matmul(dob, v.float().transpose(-1, -2))
    drow = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - drow)).to(dt).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dob)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_kernel_inputs(what: str, ref: torch.Tensor, named) -> None:
    BH, S, D = ref.shape
    for name, x in named:
        if x.dtype != torch.bfloat16 or x.shape != ref.shape \
                or not x.is_contiguous() or x.device != ref.device:
            raise ValueError(
                f"{what}: {name} must be a contiguous bf16 tensor of shape "
                f"{tuple(ref.shape)} on {ref.device}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if D not in (32, 64) or S % _BLOCK_Q:
        raise ValueError(
            f"{what} kernel takes D in (32, 64) and S % {_BLOCK_Q} == 0, "
            f"got D={D}, S={S}")


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """K1 on a CUDA tensor, ``mha_reference`` on a CPU tensor."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "mha_fwd has no gradient of its own: call mha(), whose backward "
            "is K1ᵇ")
    _check_kernel_inputs("mha_fwd", q, (("q", q), ("k", k), ("v", v)))
    BH, S, D = q.shape
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


def mha_bwd(q, k, v, o, do, scale: float):
    """K1ᵇ on CUDA tensors, ``mha_bwd_reference`` on CPU tensors.
    Returns (dq, dk, dv)."""
    if q.device.type == "cpu":
        return mha_bwd_reference(q, k, v, o, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_bwd: unsupported device {q.device}")
    _check_kernel_inputs("mha_bwd", q, (("q", q), ("k", k), ("v", v),
                                        ("o", o), ("do", do)))
    BH, S, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # Row statistics of the recomputed softmax (max, sum, rowsum(dO∘O)),
    # written by the dq pass and read by the dK/dV pass.
    stats = torch.empty(3, BH, S, dtype=torch.float32, device=q.device)
    lib = _build.load("mha_bwd", _BWD_SIGNATURES)
    err = lib.mha_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), BH, S, D, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    _build.check(lib, err, "mha_bwd")
    mha_bwd.launches += 1
    return dq, dk, dv


mha_bwd.launches = 0


class _MHA(torch.autograd.Function):
    """K1 forward, K1ᵇ backward; residuals q, k, v, o (``_mha_fwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o = mha_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, o, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float) -> torch.Tensor:
    """Attention with a gradient: ``mha_fwd``, and ``mha_bwd`` on the way
    back when autograd records the call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MHA.apply(q, k, v, scale)
    return mha_fwd(q, k, v, scale)
