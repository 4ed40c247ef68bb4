"""Cross-view multi-head attention: kernels K1 and K1ᵇ and their plain
versions.

``mha_fwd`` is the port of ``lgm_tpu/ops/mha.py``'s K-resident forward
(``_fwd_kernel`` via ``_mha_fwd``): full unmasked attention of q
``[BH, Sq, D]`` over k, v ``[BH, Sk, D]``, exact softmax (row max over
all keys, no online rescaling), P rounded to the input dtype before P.V,
f32 accumulation, output in the input dtype. With ``return_lse`` it also
returns the f32 logsumexp L = m + log(l) of each row's scaled logits (m
the row max, l the f32 sum of the unrounded P), ``[BH, Sq]``. On a CUDA
tensor it launches a hand-written kernel (bf16 or f32, D in {32, 64}, Sk
a multiple of 128, Sq of 64, scale > 0) or raises: at bf16
``csrc/mha_fwd_wgmma.cu`` (wgmma fed by TMA, one design at both head
dims), at f32 ``csrc/mha_fwd_f32.cu`` through ``mha_fwd_f32`` (3xTF32 on
wgmma fed by TMA, after the split pass ``mha_split_tf32``); on a CPU
tensor it runs ``mha_reference``, the same function in plain PyTorch.
Sq differs from Sk under the view-sharded U-Net, where a vp rank holds
the queries of its own views and the keys of all of them
(``mha_views``); each row is then bit for bit the row of the Sq = Sk
call, since a row's arithmetic reads only its own q row and every key,
and the route reads only D.

``mha_bwd`` is the port of the backward (``_bwd_kernel`` via
``_mha_bwd``): from q, k, v, o, the forward's L and the cotangent dO it
forms the normalized P = exp(s - L), dS = P∘(dO·Vᵀ − rowsum(dO∘O)) with
dO, dS and P rounded to the input dtype before their products, and
returns dq = dS·K·scale, dK = dSᵀ·Q·scale, dV = Pᵀ·dO in the input dtype
(dK and dV in f32 with ``dkv_f32``: a vp rank's partial sums, summed over
the ranks before one rounding). On a CUDA tensor it launches
``csrc/mha_bwd_wgmma.cu`` at bf16, ``csrc/mha_bwd_f32.cu`` through
``mha_bwd_f32`` at f32; on a CPU tensor it runs ``mha_bwd_reference``.

At f32 nothing is rounded below f32: the kernels compute exact softmax
attention and its exact backward at f32 grade, as the plain versions do
at f32 (and as ``lgm_tpu`` runs f32 attention wherever its kernel does
not run). ``lgm_tpu``'s kernel body rounds P, dO and dS to bf16 at any
input dtype (``lgm_tpu/ops/mha.py:54,91,97,108``); the port does not at
f32, a deliberate difference (README). The f32 kernels take their
products by 3xTF32 (each f32 operand split into two TF32 halves, three
tensor-core products), about 2^-22 of the scale from f32 products; one
TF32 pass alone (2^-11) would not be f32 grade. The split pass
(``mha_split_tf32``, ``csrc/mha_split_tf32.cu``, plain version
``split_tf32_reference``) writes each operand's halves once a call, as
the planes the kernels' TMA loads read: row-major for the products over
D and, since TF32 wgmma reads its operands K-major only, transposed with
the rows of each 8-row group permuted (``TF32_PERM``) for the products
over the rows, whose A operand is P or dS straight from the
accumulators.
``mha`` joins the two in an autograd Function, and ``mha_views`` does so
for a vp rank, gathering K and V over the group and summing their
gradients back. Each kernel's design note and bound are in its source.

The residuals are q, k, v, o **and L**, where ``_mha_fwd`` saves only q,
k, v, o and its backward recomputes the row max and sum in two extra
passes over the keys. That was the TPU's constraint: a ``[BH, S, 1]`` f32
residual lane-pads 128× in VMEM (an OOM there). On the H100 L costs its
4 bytes a row (~3.4 MB over the 16 sites of a bs2 step), and reading it
saves K1ᵇ two passes of Q·Kᵀ and one exp per logit. P = exp(s − L)
equals exp(s − m)/l up to f32 rounding, so the function is the same.

The TPU kernel ran only at S >= 2048 (``lgm_tpu/models/unet.py:61-62``),
a VMEM/HBM choice of that chip; the port runs the kernels at every
MVAttention site, since the function is the same at each. The diffusion
U-Net (``diffusion/mv_unet.py::attention``) keeps ``lgm_tpu``'s own gate
for its K-resident route: K1 at the level-0 joint self-attention (S 4096
or 5120, D 64, BH 10 at 256²).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lgm_tpu_torch.ops import _build
from lgm_tpu_torch.parallel import dist

_WGMMA_SIGNATURES = {
    "mha_fwd_wgmma_bf16": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_int] + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_WGMMA_BWD_SIGNATURES = {
    "mha_bwd_wgmma_bf16": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_F32_SIGNATURES = {
    "mha_fwd_f32": (
        [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_F32_BWD_SIGNATURES = {
    "mha_bwd_f32": (
        [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_SPLIT_SIGNATURES = {
    "mha_split_tf32": (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_TILE = 128  # keys per staged tile; Sk must be a multiple
# Queries per staged tile of the dK/dV kernel where Sq is not a multiple
# of _TILE; Sq must be a multiple.
_Q_TILE = 64
# The design of each kernel: "wgmma" (wgmma fed by TMA,
# ``csrc/mha_fwd_wgmma.cu`` / ``mha_bwd_wgmma.cu``, D = 32 and 64).
ROUTES = ("wgmma",)
# The one design of the f32 kernels (``csrc/mha_fwd_f32.cu`` /
# ``mha_bwd_f32.cu``): 3xTF32 on wgmma m64nNk8 fed by TMA from the split
# pass's planes (``mha_split_tf32``), at D = 32 and 64.
F32_ROUTE = "tf32x3_wgmma"
# Row p of each 8-row group of a transposed plane holds row TF32_PERM[p]
# (``split_tf32_reference``; ``csrc/mha_f32.cuh``).
TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def route(D: int) -> str:
    """The design the bf16 K1 and K1ᵇ take at head dim ``D``: "wgmma" at D
    = 32 and 64 (f32 inputs take ``F32_ROUTE``, the one design of the f32
    kernels). It reads neither length, so a vp rank (Sq = S/vp) and the
    full call run the same arithmetic.

    The wgmma design replaced an mma.sync one (m16n8k16 fed by cp.async)
    at both head dims, where it was faster than that design beyond its
    spread at every row the port runs, or inside it where the host's
    enqueue bounds both (S 256): device times of K1 and K1ᵇ at LGM big's
    sites (B = 1 and bs2), a vp rank's lengths and the diffusion U-Net's
    level 0, parent and change in turns in one call of
    ``scripts/time_attention.py`` (PERF.md)."""
    return "wgmma"


def warpgroups(BH: int, rows: int, sms: int, D: int) -> int:
    """Consumer warpgroups (64 rows each) a block of the wgmma kernels over
    ``rows`` (queries in K1 and the dq kernel, keys in the dK/dV kernel),
    one block an SM: at D = 32, 4 where 256-row blocks divide the rows and
    fill every one of the ``sms`` multiprocessors at least once; else 2
    where 128-row blocks divide the rows and the 64-row units outnumber
    the multiprocessors; else 1 (more SMs busy). A row's arithmetic does
    not depend on the block."""
    if D == 32 and rows % 256 == 0 and rows // 256 * BH >= sms:
        return 4
    return 2 if rows % 128 == 0 and rows // 64 * BH > sms else 1


def f32_warpgroups(BH: int, Sq: int, Sk: int, D: int, sms: int) -> dict:
    """Consumer warpgroups (64 rows each) a block of the f32 kernels: K1
    ``fwd`` as the bf16 K1 (``warpgroups``: 1, 2, or 4 at D = 32); K1ᵇ's
    ``dq`` and ``dkv`` kernels at most 2 at D = 32 and 1 at D = 64, where
    a dK/dV consumer holds four accumulators and two products' A operands
    (its registers would not fit a smaller share) and two dq consumers
    would spill and ran no faster (PERF.md). A row's arithmetic
    does not depend on the block."""
    fwd = warpgroups(BH, Sq, sms, D)
    if D == 64:
        return dict(fwd=fwd, dq=1, dkv=1)
    return dict(fwd=fwd, dq=min(2, fwd),
                dkv=min(2, warpgroups(BH, Sk, sms, D)))


def launch_plan(BH: int, Sq: int, Sk: int, D: int, sms: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """How K1 and K1ᵇ launch at this shape and dtype on ``sms``
    multiprocessors: the design (``route`` at bf16, ``F32_ROUTE`` at f32)
    and a block of each kernel (K1 ``fwd`` and K1ᵇ's ``dq`` over the
    queries, ``dkv`` over the keys): consumer warpgroups of 64 rows
    (``warpgroups`` at bf16, ``f32_warpgroups`` at f32)."""
    if dtype is torch.float32:
        return dict(route=F32_ROUTE, **f32_warpgroups(BH, Sq, Sk, D, sms))
    return dict(route=route(D), fwd=warpgroups(BH, Sq, sms, D),
                dq=warpgroups(BH, Sq, sms, D), dkv=warpgroups(BH, Sk, sms, D))


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, return_lse: bool = False):
    """Plain version of K1: q [BH, Sq, D], k/v [BH, Sk, D] -> [BH, Sq, D]
    in q's dtype, and with ``return_lse`` also the f32 row logsumexp
    [BH, Sq]. P is rounded to v's dtype before P·V: bf16 on the bf16
    route, no rounding at f32, where this is exact softmax attention (the
    plain version of the f32 kernel too)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    s = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p.to(v.dtype).float(), v.float()) / s).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(s)).squeeze(-1)
    return o


def mha_bwd_reference(q, k, v, o, do, scale: float, lse,
                      dkv_f32: bool = False):
    """Plain version of K1ᵇ: (dq, dk, dv), dq [BH, Sq, D] and dk, dv
    [BH, Sk, D], in q's dtype (dk and dv in f32, unrounded, with
    ``dkv_f32``).

    The arithmetic of ``lgm_tpu/ops/mha.py::_bwd_kernel`` with P's
    statistics read from the forward's ``lse``: P = exp(s − L) normalized
    in f32; dO, dS and P rounded to the input dtype before their products
    (bf16 on the card; no rounding at f32, where this is the exact
    softmax-attention backward and the plain version of the f32 kernel);
    f32 accumulation."""
    dt = q.dtype
    qf, kf = q.float(), k.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(logits - lse.float().unsqueeze(-1))
    dob = do.to(dt).float()
    dp = torch.matmul(dob, v.float().transpose(-1, -2))
    drow = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - drow)).to(dt).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dob)
    if dkv_f32:
        return dq.to(dt), dk, dv
    return dq.to(dt), dk.to(dt), dv.to(dt)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as the f32 kernels round it: the magnitude
    to nearest at bit 13 of the f32 pattern, ties away from zero, the low
    13 bits cleared (``csrc/mha_f32.cuh::rna``, the same integer
    arithmetic)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _perm_rows(R: int, device) -> torch.Tensor:
    """The row each row of a transposed plane holds: 8-row groups in the
    order ``TF32_PERM``."""
    r = torch.arange(R, device=device)
    return r - r % 8 + torch.tensor(TF32_PERM, device=device)[r % 8]


def split_tf32_reference(x: torch.Tensor, rows: bool = True,
                         cols: bool = False) -> dict:
    """Plain version of the split pass: x [BH, R, D] f32 into its TF32
    halves hi = rna(x), lo = rna(x - hi) (x = hi + lo to ~2^-22 of |x|):
    ``hi``, ``lo`` [BH, R, D] where ``rows``, and the transposed planes
    ``hi_t``, ``lo_t`` [BH, D, R] where ``cols``, each 8-row group in the
    order ``TF32_PERM`` (row p of a group holds row TF32_PERM[p])."""
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    out = {}
    if rows:
        out.update(hi=hi, lo=lo)
    if cols:
        idx = _perm_rows(x.shape[1], x.device)
        out.update(hi_t=hi[:, idx].transpose(1, 2).contiguous(),
                   lo_t=lo[:, idx].transpose(1, 2).contiguous())
    return out


def _split(operands, BH: int, D: int, dev, stream):
    """Launch the split pass on ``operands`` ((x, rows, cols) triples,
    checked by the caller) into one new buffer; returns the buffer and,
    for each operand, the element offsets of its planes hi, lo (rows) and
    hi_t, lo_t (cols), None for a plane not asked for."""
    sizes = [x.numel() for x, _, _ in operands]
    buf = torch.empty(sum(2 * (bool(r) + bool(c)) * n for (_, r, c), n
                          in zip(operands, sizes)),
                      dtype=torch.float32, device=dev)
    base, at, offsets, ptrs = buf.data_ptr(), 0, [], []
    for (x, rows, cols), n in zip(operands, sizes):
        offs = []
        for ask in (rows, rows, cols, cols):
            offs.append(at if ask else None)
            at += n if ask else 0
        offsets.append(offs)
        ptrs += [x.data_ptr()] + [None if o is None else base + 4 * o
                                  for o in offs]
    lib = _build.load("mha_split_tf32", _SPLIT_SIGNATURES)
    err = lib.mha_split_tf32(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(operands))(*(x.shape[1] for x, _, _ in operands)),
        len(operands), BH, D, stream, dev.index)
    _build.check(lib, err, "mha_split_tf32")
    mha_split_tf32.launches += 1
    return buf, offsets


def mha_split_tf32(operands) -> list:
    """The split pass of the f32 kernels on CUDA tensors
    (``csrc/mha_split_tf32.cu``, one launch for up to four operands),
    ``split_tf32_reference`` on CPU tensors. ``operands``: (x, rows, cols)
    triples, x [BH, R, D] contiguous f32 (one BH and D for all, R a
    multiple of 32); returns for each the dict of its planes, as the plain
    version. Counts its launches, the f32 kernels' own calls of the pass
    (``_split``) included."""
    operands = list(operands)
    if operands[0][0].device.type == "cpu":
        return [split_tf32_reference(x, rows, cols)
                for x, rows, cols in operands]
    x0 = operands[0][0]
    dev = x0.device
    if dev.type != "cuda":
        raise ValueError(f"mha_split_tf32: unsupported device {dev}")
    BH, _, D = x0.shape
    if not 1 <= len(operands) <= 4:
        raise ValueError("mha_split_tf32 takes one to four operands")
    for x, rows, cols in operands:
        if (x.dtype is not torch.float32 or x.device != dev
                or not x.is_contiguous() or x.dim() != 3
                or x.shape[0] != BH or x.shape[2] != D or D not in (32, 64)
                or x.shape[1] % 32 or not (rows or cols)):
            raise ValueError(
                f"mha_split_tf32: each operand a contiguous f32 [BH, R, D] "
                f"tensor on {dev}, BH {BH}, D {D} in (32, 64), R a multiple "
                f"of 32, rows or cols asked; got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    buf, offsets = _split(operands, BH, D, dev,
                          torch.cuda.current_stream(dev).cuda_stream)
    out = []
    for (x, _, _), offs in zip(operands, offsets):
        R = x.shape[1]
        out.append({key: buf[o:o + x.numel()].view(
            (BH, R, D) if key in ("hi", "lo") else (BH, D, R))
            for key, o in zip(("hi", "lo", "hi_t", "lo_t"), offs)
            if o is not None})
    return out


mha_split_tf32.launches = 0


def kernel_takes(dtype: torch.dtype, Sq: int, Sk: int, D: int,
                 scale: float) -> bool:
    """Whether K1 and K1ᵇ take attention of this dtype and shape: bf16 (the
    wgmma kernels) or f32 (the 3xTF32 kernels, exact f32 softmax
    attention), D in (32, 64), Sk keys a multiple of 128, Sq queries a
    positive multiple of 64 and scale > 0 (what the wrappers check on a
    CUDA tensor)."""
    return (dtype in (torch.bfloat16, torch.float32) and D in (32, 64) and Sk % _TILE == 0
            and Sq > 0 and Sq % _Q_TILE == 0 and scale > 0)


def _check_kernel_inputs(what: str, dt: torch.dtype, q: torch.Tensor,
                         k: torch.Tensor, named, scale: float,
                         lse=None) -> None:
    """``named`` are (name, tensor) pairs, each of q's shape ([BH, Sq,
    D]) or of k's ([BH, Sk, D]) as its name says (k, v, dk, dv), and all
    of the kernel's dtype ``dt``: bf16 throughout or f32 throughout. The
    statistic is f32 in both."""
    dev = q.device
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    for name, x in named:
        shape = (BH, Sk, D) if name in ("k", "v") else (BH, Sq, D)
        if x.dtype is not dt or tuple(x.shape) != shape \
                or x.device != dev or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} must be a contiguous, 16-byte aligned "
                f"{dt} tensor of shape {shape} on {dev} (every tensor of a "
                f"call bf16, or every one f32), got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if lse is not None and (lse.dtype is not torch.float32
                            or lse.shape != (BH, Sq) or lse.device != dev
                            or not lse.is_contiguous()):
        raise ValueError(
            f"{what}: lse must be a contiguous f32 tensor of shape "
            f"{(BH, Sq)} on {dev}, got {lse.dtype} {tuple(lse.shape)} on "
            f"{lse.device}")
    if not kernel_takes(q.dtype, Sq, Sk, D, scale):
        raise ValueError(
            f"{what} kernel takes bf16 or f32, D in (32, 64), "
            f"Sk % {_TILE} == 0, "
            f"Sq % {_Q_TILE} == 0 and scale > 0, got D={D}, Sq={Sq}, "
            f"Sk={Sk}, scale={scale}")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cuda_call(what: str, q, k, v) -> torch.device:
    """The device of a kernel call on CUDA tensors; raises on another
    device, and where autograd records the call (``mha`` is the entry with
    a gradient)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            f"{what} has no gradient of its own: call mha(), whose backward "
            "is K1ᵇ")
    return dev


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, return_lse: bool = False):
    """K1 on a CUDA tensor, ``mha_reference`` on a CPU tensor. Returns o,
    or (o, lse) with ``return_lse`` (the kernel writes lse only then). f32
    inputs go to ``mha_fwd_f32``; nothing is converted to bf16."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale, return_lse)
    if q.dtype is torch.float32:
        return mha_fwd_f32(q, k, v, scale, return_lse)
    dev = _cuda_call("mha_fwd", q, k, v)
    _check_kernel_inputs("mha_fwd", torch.bfloat16, q, k,
                         (("q", q), ("k", k), ("v", v)), scale)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    o = torch.empty_like(q)
    lse = (torch.empty(BH, Sq, dtype=torch.float32, device=dev)
           if return_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, Sq, Sk, D,
            float(scale))
    stream = torch.cuda.current_stream(dev).cuda_stream
    r = route(D)
    lib = _build.load("mha_fwd_wgmma", _WGMMA_SIGNATURES)
    err = lib.mha_fwd_wgmma_bf16(*args, warpgroups(BH, Sq, _sms(dev), D),
                                 stream, dev.index)
    _build.check(lib, err, "mha_fwd")
    mha_fwd.launches += 1
    mha_fwd.route_launches[r] += 1
    return (o, lse) if return_lse else o


mha_fwd.launches = 0
# Launches by route (``route``): which design ran.
mha_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def mha_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, return_lse: bool = False):
    """K1 on f32 CUDA tensors (the split pass, then
    ``csrc/mha_fwd_f32.cu``), ``mha_reference`` on CPU tensors: exact f32
    softmax attention, o f32 and with ``return_lse`` the f32 row
    statistic. Counts its own launches (the split pass counts its
    own)."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale, return_lse)
    dev = _cuda_call("mha_fwd_f32", q, k, v)
    _check_kernel_inputs("mha_fwd_f32", torch.float32, q, k,
                         (("q", q), ("k", k), ("v", v)), scale)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    o = torch.empty_like(q)
    lse = (torch.empty(BH, Sq, dtype=torch.float32, device=dev)
           if return_lse else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The operands' TF32 halves: Q and K row-major, V transposed (the
    # buffer lives until the kernel is enqueued).
    buf, offs = _split(((q, True, False), (k, True, False),
                        (v, False, True)), BH, D, dev, stream)
    base = buf.data_ptr()
    planes = [base + 4 * o for op in offs for o in op if o is not None]
    lib = _build.load("mha_fwd_f32", _F32_SIGNATURES)
    err = lib.mha_fwd_f32(
        (ctypes.c_void_p * 6)(*planes), o.data_ptr(),
        None if lse is None else lse.data_ptr(), BH, Sq, Sk, D, float(scale),
        f32_warpgroups(BH, Sq, Sk, D, _sms(dev))["fwd"], stream, dev.index)
    _build.check(lib, err, "mha_fwd_f32")
    mha_fwd_f32.launches += 1
    return (o, lse) if return_lse else o


mha_fwd_f32.launches = 0


def mha_bwd(q, k, v, o, do, scale: float, lse, dkv_f32: bool = False):
    """K1ᵇ on CUDA tensors, ``mha_bwd_reference`` on CPU tensors; ``lse``
    is the forward's ``[BH, Sq]`` f32 statistic. Returns (dq, dk, dv), dk
    and dv in f32 with ``dkv_f32``. f32 inputs go to ``mha_bwd_f32``,
    whose outputs are all f32 (so ``dkv_f32`` changes nothing there)."""
    dev = q.device
    if dev.type == "cpu":
        return mha_bwd_reference(q, k, v, o, do, scale, lse, dkv_f32)
    if q.dtype is torch.float32:
        return mha_bwd_f32(q, k, v, o, do, scale, lse)
    if dev.type != "cuda":
        raise ValueError(f"mha_bwd: unsupported device {dev}")
    _check_kernel_inputs("mha_bwd", torch.bfloat16, q, k,
                         (("q", q), ("k", k), ("v", v), ("o", o),
                          ("do", do)), scale, lse)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    dq = torch.empty_like(q)
    dk, dv = (torch.empty_like(k, dtype=torch.float32 if dkv_f32 else None)
              for _ in range(2))
    # rowsum(dO∘O), written by the dq kernel and read by the dK/dV kernel.
    drow = torch.empty(BH, Sq, dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), drow.data_ptr(), BH, Sq, Sk, D, float(scale))
    stream = torch.cuda.current_stream(dev).cuda_stream
    r = route(D)
    sms = _sms(dev)
    lib = _build.load("mha_bwd_wgmma", _WGMMA_BWD_SIGNATURES)
    err = lib.mha_bwd_wgmma_bf16(*args, warpgroups(BH, Sq, sms, D),
                                 warpgroups(BH, Sk, sms, D), int(dkv_f32),
                                 stream, dev.index)
    _build.check(lib, err, "mha_bwd")
    mha_bwd.launches += 1
    mha_bwd.route_launches[r] += 1
    return dq, dk, dv


mha_bwd.launches = 0
mha_bwd.route_launches = dict.fromkeys(ROUTES, 0)


def mha_bwd_f32(q, k, v, o, do, scale: float, lse):
    """K1ᵇ on f32 CUDA tensors (the split pass, then
    ``csrc/mha_bwd_f32.cu``, a dq kernel and a dK/dV kernel, no atomics),
    ``mha_bwd_reference`` on CPU tensors: the
    exact f32 softmax-attention backward from the forward's ``[BH, Sq]``
    f32 statistic. Returns f32 (dq, dk, dv); a vp rank's dk and dv are its
    f32 partial sums. Counts its own launches."""
    dev = q.device
    if dev.type == "cpu":
        return mha_bwd_reference(q, k, v, o, do, scale, lse)
    if dev.type != "cuda":
        raise ValueError(f"mha_bwd_f32: unsupported device {dev}")
    _check_kernel_inputs("mha_bwd_f32", torch.float32, q, k,
                         (("q", q), ("k", k), ("v", v), ("o", o),
                          ("do", do)), scale, lse)
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # rowsum(dO∘O), written by the dq kernel and read by the dK/dV kernel.
    drow = torch.empty(BH, Sq, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The operands' TF32 halves: Q, dO, K, V row-major; Q, dO, K
    # transposed (the buffer lives until the kernels are enqueued).
    buf, offs = _split(((q, True, True), (do, True, True), (k, True, True),
                        (v, True, False)), BH, D, dev, stream)
    base = buf.data_ptr()
    q_, do_, k_, v_ = ([None if o is None else base + 4 * o for o in op]
                       for op in offs)
    planes = q_[:2] + do_[:2] + k_[:2] + v_[:2] + q_[2:] + do_[2:] + k_[2:]
    plan = f32_warpgroups(BH, Sq, Sk, D, _sms(dev))
    lib = _build.load("mha_bwd_f32", _F32_BWD_SIGNATURES)
    err = lib.mha_bwd_f32(
        (ctypes.c_void_p * 14)(*planes), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        drow.data_ptr(), BH, Sq, Sk, D, float(scale), plan["dq"],
        plan["dkv"], stream, dev.index)
    _build.check(lib, err, "mha_bwd_f32")
    mha_bwd_f32.launches += 1
    return dq, dk, dv


mha_bwd_f32.launches = 0


class _MHA(torch.autograd.Function):
    """K1 forward, K1ᵇ backward; residuals q, k, v, o and the f32 row
    logsumexp (``_mha_fwd`` saves no statistic: see the module note)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = mha_fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, o, do.contiguous(), ctx.scale, lse)
        return dq, dk, dv, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float) -> torch.Tensor:
    """Attention with a gradient: ``mha_fwd``, and ``mha_bwd`` on the way
    back when autograd records the call."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MHA.apply(q, k, v, scale)
    return mha_fwd(q, k, v, scale)


class _MHAViews(torch.autograd.Function):
    """K1 and K1ᵇ on one vp rank of the view-sharded U-Net: q holds the
    rank's own tokens ([BH, S/vp, D]), k and v too; the forward gathers k
    and v over the vp ``group`` in rank order (the one-process token
    order) and runs K1 at Sq = S/vp, Sk = S. The backward runs K1ᵇ with
    f32 dK and dV, the rank's partial sums over its own queries, sums
    them over the group (``dist.reduce_scatter_axis``) and rounds the
    rank's own slice once, as one process rounds the whole sum once.
    Residuals: q, the gathered k and v, o and the row logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group):
        kv = dist.gather_axis(torch.stack((k, v)), 2, group)
        k_all, v_all = kv[0], kv[1]
        o, lse = mha_fwd(q, k_all, v_all, scale, return_lse=True)
        ctx.save_for_backward(q, k_all, v_all, o, lse)
        ctx.scale, ctx.group = scale, group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, o, do.contiguous(), ctx.scale, lse,
                             dkv_f32=True)
        dkv = dist.reduce_scatter_axis(torch.stack((dk, dv)), 2, ctx.group)
        dkv = dkv.to(q.dtype)
        return dq, dkv[0], dkv[1], None, None


def mha_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, group) -> torch.Tensor:
    """``mha`` on one vp rank: the rank's queries attend to the keys and
    values of every rank of ``group`` (each [BH, S/vp, D], gathered in
    rank order), through ``_MHAViews``."""
    return _MHAViews.apply(q, k, v, scale, group)
