"""Flat-sort Gaussian rasterizer: host-side binning and kernels K2, K2ᵇ.

Port of ``lgm_tpu/ops/gsplat/flatsort.py``. Per view:

1. ``project`` (``projection.py``): one launch of ``csrc/project_fwd.cu``
   on a CUDA tensor, the depth row among the slot rows where asked, and
   one of ``csrc/project_bwd.cu`` on the way back; ``project_gaussians``
   (plain PyTorch, SoA) on a CPU tensor.
2. ``_flat_binning`` on the projection without gradient (as lgm_tpu's
   ``stop_gradient``): each active splat enumerates 2*dup candidate tiles
   over its exact ellipse AABB, drops provably-zero (splat, tile) pairs by
   the conic-vs-tile test, keeps its first ``dup`` live tiles; keys
   ``tile_id * N + depth_rank`` sorted once group the entries per tile
   front to back; each tile keeps its first MPT (nearest) entries.
3. The slot gather: per-Gaussian rows (x̄, ȳ, A, B, C, op, r, g, b[, z])
   in depth-rank order (``_PermuteRows``; its gradient is the inverse
   gather) plus a zero pad row, gathered per slot (``_GatherRows``; its
   gradient is a scatter-add onto the rank rows, the pad row's share
   dropped); dead slots point at the pad row. The port's slot layout is
   ``[T, MPT, R]`` slot-major (the gather output itself, coalesced for
   the kernels).
4. ``composite``: kernel K2 (``csrc/composite_fwd.cu``) forward and K2ᵇ
   (``csrc/composite_bwd.cu``) backward on CUDA tensors, their plain
   versions ``composite_reference`` / ``composite_bwd_reference`` on CPU
   tensors. The backward saves params, counts and the output, as
   ``_cf_fwd`` does, and K2's pixel state at every 128-slot chunk
   boundary (``[T, MPT/128, 6, P]``: T and the accumulators r, g, b,
   alpha, depth), which K2 writes only when asked: K2ᵇ runs one block per
   (tile, chunk), each starting from its chunk's stored state.
5. ``_pack_output``: [T, 8, P] -> image / alpha / depth.

In a profiled run (``lgm_tpu_torch/trace.py``) each view's steps 1-4 are
the ranges ``render.project``, ``render.bin``, ``render.gather`` and
``render.composite``, K2ᵇ is ``render.composite.backward``, and K2 and
K2ᵇ count their launches and the work their data gives them
(``composite_fwd.*``, ``composite_bwd.*``: the (pixel, slot) pairs they
visit and the bytes they move), from which a roofline is read.

Traps kept from the JAX module: the depth argsort is stable (as
``jnp.argsort``); the per-row sort of the [N, 2*dup] candidates keeps
the first ``dup``; ``counts`` is capped at MPT; ``T * N < 2**31`` is
required, as lgm_tpu's int32 keys require it; the backward replays the
forward's tile-wide early-out, so it differentiates the same function.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from lgm_tpu_torch import trace
from lgm_tpu_torch.ops import _build
from lgm_tpu_torch.ops.gsplat.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    log_alpha_min,
    project,
)

# Slots per compositing chunk (the TPU's lane width; the kernel's staging
# unit) and the transmittance early-out threshold (the CUDA rasterizer's).
G_CHUNK = 128
T_EPS = 1e-4

_SIGNATURES = {
    "composite_fwd_f32": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}

_BWD_SIGNATURES = {
    "composite_bwd_f32": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}

# K2's launch shape at 32 x 32 tiles, (cluster size, pixels a thread):
# each tile is composited by a cluster of that many blocks, each thread
# owning that many pixels. Chosen by measurement (PERF.md: every variant
# of ``VARIANTS`` timed in one call by scripts/time_compositors.py):
# the fastest on the orbit's heavy frame 0, 3-6% behind (2, 2) on the
# bench view.
K2_VARIANT = (4, 2)
# Every (cluster, pixels a thread) the kernels are built for.
VARIANTS = tuple((cs, ppt) for cs in (1, 2, 4) for ppt in (1, 2, 4))


def launch_shape(P: int, variant: Tuple[int, int]) -> Tuple[int, int]:
    """The (cluster, pixels a thread) K2 or K3 launches with for tiles of
    ``P`` pixels (a multiple of 32): ``variant``, with pixels a thread and
    then the cluster halved until each block is whole warps
    (``P % (32 * cluster * ppt) == 0``). A choice by shape only."""
    cs, ppt = variant
    if (cs, ppt) not in VARIANTS:
        raise ValueError(f"no kernel is built for (cluster, pixels a "
                         f"thread) = {variant}; built: {VARIANTS}")
    while P % (32 * cs * ppt):
        if ppt > 1:
            ppt //= 2
        else:
            cs //= 2
    return cs, ppt


class FlatBins(NamedTuple):
    flat_rank: torch.Tensor  # [T*MPT] depth rank per slot (N = dead pad)
    counts: torch.Tensor     # [T] valid entries per tile (int32)
    order: torch.Tensor      # [N] gaussian id per depth rank
    rank: torch.Tensor       # [N] depth rank per gaussian (order's inverse)


def _mpt(max_per_tile: int) -> int:
    return max(G_CHUNK, (max_per_tile // G_CHUNK) * G_CHUNK)


def _tile_bboxes_xy(mean2d, radius_x, radius_y, tile_h, tile_w, tiles_y,
                    tiles_x):
    """Inclusive-exclusive tile ranges of each splat's per-axis extent."""
    def rng(c, r, tile, n):
        lo = torch.clamp(torch.floor((c - r) / tile), 0, n)
        hi = torch.clamp(torch.floor((c + r) / tile) + 1, 0, n)
        return lo.long(), hi.long()

    x0, x1 = rng(mean2d[:, 0], radius_x, tile_w, tiles_x)
    y0, y1 = rng(mean2d[:, 1], radius_y, tile_h, tiles_y)
    return x0, x1, y0, y1


def _flat_binning(proj, tiles_y: int, tiles_x: int, tile_h: int,
                  tile_w: int, dup: int, max_per_tile: int = 1024
                  ) -> FlatBins:
    N = proj.mean2d.shape[0]
    T = tiles_y * tiles_x
    MPT = _mpt(max_per_tile)
    dev = proj.mean2d.device

    active = proj.valid & (proj.radius > 0)
    order = torch.argsort(
        torch.where(active, proj.depth,
                    torch.full_like(proj.depth, float("inf"))), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=dev)

    x0, x1, y0, y1 = _tile_bboxes_xy(proj.mean2d, proj.radius_x,
                                     proj.radius_y, tile_h, tile_w,
                                     tiles_y, tiles_x)
    w, h = x1 - x0, y1 - y0
    d = torch.arange(2 * dup, device=dev)
    wi = torch.clamp(w, min=1)[:, None]
    tx = x0[:, None] + d[None, :] % wi
    ty = y0[:, None] + d[None, :] // wi
    slot_ok = active[:, None] & (d[None, :] < (w * h)[:, None])

    # Exact conic-vs-tile cull: keep a pair only if the quadratic's min over
    # the tile's pixel-center rect passes the alpha cutoff.
    A = proj.conic[:, 0:1]
    Bc = proj.conic[:, 1:2]
    C = proj.conic[:, 2:3]
    rx0 = tx.float() * tile_w - proj.mean2d[:, 0:1]
    rx1 = rx0 + (tile_w - 1)
    ry0 = ty.float() * tile_h - proj.mean2d[:, 1:2]
    ry1 = ry0 + (tile_h - 1)
    A_s = torch.clamp(A, min=1e-8)
    C_s = torch.clamp(C, min=1e-8)

    def clip(x, lo, hi):  # jnp.clip: min(max(x, lo), hi)
        return torch.minimum(torch.maximum(x, lo), hi)

    def edge_x(e):  # dx fixed at e, dy free in [ry0, ry1]
        dy = clip(-Bc * e / C_s, ry0, ry1)
        return A * e * e + 2.0 * Bc * e * dy + C * dy * dy

    def edge_y(e):  # dy fixed at e, dx free in [rx0, rx1]
        dx = clip(-Bc * e / A_s, rx0, rx1)
        return A * dx * dx + 2.0 * Bc * dx * e + C * e * e

    qmin = torch.minimum(torch.minimum(edge_x(rx0), edge_x(rx1)),
                         torch.minimum(edge_y(ry0), edge_y(ry1)))
    inside = (rx0 <= 0) & (0 <= rx1) & (ry0 <= 0) & (0 <= ry1)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    tau = 2.0 * (torch.log(torch.clamp(proj.opacity[:, None], min=1e-12))
                 - log_alpha_min(qmin))
    slot_ok = slot_ok & (qmin <= tau)

    tile_id = ty * tiles_x + tx
    invalid = T * N
    key2d = torch.where(slot_ok, tile_id * N + rank[:, None],
                        torch.full_like(tile_id, invalid))
    # Live-cell compaction: rank is constant per row, so sorting a row
    # moves its live keys to the front in tile order; keep the first dup.
    key = torch.sort(key2d, dim=1).values[:, :dup].reshape(-1)
    skeys = torch.sort(key).values
    tgrid = torch.arange(T + 1, device=dev) * N
    bounds = torch.searchsorted(skeys, tgrid)
    starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - starts, max=MPT)

    # Slot (t, i) -> sorted entry starts[t] + i (contiguous per tile).
    skeys_pad = torch.cat(
        [skeys, torch.full((MPT,), invalid, dtype=skeys.dtype, device=dev)])
    pos = torch.arange(MPT, device=dev)
    keys_t = skeys_pad[starts[:, None] + pos[None, :]]
    live = pos[None, :] < counts[:, None]
    tvec = torch.arange(T, device=dev)
    flat_rank = torch.where(live, keys_t - (tvec * N)[:, None],
                            torch.full_like(keys_t, N)).reshape(-1)
    return FlatBins(flat_rank, counts.to(torch.int32), order, rank)


def _prepare_view(gaussians, view, image_size, tan_half_fov,
                  scale_modifier, tile_h, tile_w, dup, max_per_tile,
                  with_depth) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection + binning + slot gather for one view: the composite's
    inputs (params [T, MPT, R] f32, counts [T] int32)."""
    S = image_size
    if S % tile_h or S % tile_w:
        raise ValueError(f"image size {S} is not a multiple of the "
                         f"{tile_h}x{tile_w} tile")
    tiles_y, tiles_x = S // tile_h, S // tile_w
    T = tiles_y * tiles_x
    N = gaussians.shape[0]
    # lgm_tpu's int32 keys; kept so both packages take the same inputs.
    if T * N >= 2**31:
        raise ValueError(f"{T} tiles x {N} splats exceed the 2**31 keys")
    MPT = _mpt(max_per_tile)

    with trace.span("render.project"):
        proj = project(gaussians, view, S, tan_half_fov, scale_modifier,
                       with_depth)
    with trace.span("render.bin"), torch.no_grad():
        meta = _flat_binning(proj, tiles_y, tiles_x, tile_h, tile_w, dup,
                             max_per_tile)
    with trace.span("render.gather"):
        attrs = _PermuteRows.apply(proj.attrs_t.T, meta.order, meta.rank)
        attrs = torch.cat([attrs, torch.zeros_like(attrs[:1])], dim=0)
        params = _GatherRows.apply(attrs, meta.flat_rank)
        return params.reshape(T, MPT, attrs.shape[1]), meta.counts


class _PermuteRows(torch.autograd.Function):
    """x[perm] whose gradient is the inverse gather g[inv_perm]
    (``_permute_rows``): a permutation needs no scatter."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        inv_perm, = ctx.saved_tensors
        return g[inv_perm], None, None


class _GatherRows(torch.autograd.Function):
    """attrs_pad [N+1, R] -> per-slot rows [T*MPT, R] (``_gather_entries``).
    The gradient is one scatter-add (``index_add_``) back onto the rank
    rows; dead slots carry index N, the pad row, whose share is dropped."""

    @staticmethod
    def forward(ctx, attrs_pad, flat_rank):
        ctx.save_for_backward(flat_rank)
        ctx.n_pad = attrs_pad.shape[0]
        return attrs_pad[flat_rank]

    @staticmethod
    def backward(ctx, g):
        flat_rank, = ctx.saved_tensors
        d = torch.zeros(ctx.n_pad, g.shape[1], dtype=g.dtype,
                        device=g.device)
        return d.index_add_(0, flat_rank, g), None


def _composite_plain(params, counts, tile_h, tile_w, tiles_x,
                     with_state=False):
    """K2's function in plain PyTorch, all tiles at once, chunk by chunk.
    Returns (out [T, 8, P], visited [T], used, state): ``visited`` counts
    the slots each tile's chunk loop walked (the kernel's work per pixel),
    ``used`` the (pixel, slot) pairs that passed the alpha test, and
    ``state`` (None unless ``with_state``) is K2's ``[T, MPT/128, 6, P]``:
    at the boundary before each chunk, each pixel's transmittance and its
    accumulators r, g, b, alpha and depth; past the chunks a tile
    composites, the tile's final values."""
    T, MPT, R = params.shape
    P = tile_h * tile_w
    dev = params.device
    pix = torch.arange(P, device=dev)
    lx = (pix % tile_w).float()
    ly = torch.div(pix, tile_w, rounding_mode="floor").float()
    tid = torch.arange(T, device=dev)
    tox = ((tid % tiles_x) * tile_w).float()[:, None]
    toy = (torch.div(tid, tiles_x, rounding_mode="floor") * tile_h
           ).float()[:, None]
    counts = counts.long()

    Tr = torch.ones(T, P, dtype=params.dtype, device=dev)
    acc = torch.zeros(T, 8, P, dtype=params.dtype, device=dev)
    visited = torch.zeros(T, dtype=torch.long, device=dev)
    used = 0
    state = (torch.empty(T, MPT // G_CHUNK, 6, P, dtype=params.dtype,
                         device=dev) if with_state else None)
    for c0 in range(0, MPT, G_CHUNK):
        c = c0 // G_CHUNK
        if state is not None:
            state[:, c, 0] = Tr
            state[:, c, 1:5] = acc[:, 0:4]
            state[:, c, 5] = acc[:, 5]
        live = (c0 < counts) & (Tr.amax(dim=1) > T_EPS)       # [T]
        if not bool(live.any()):
            if state is not None:
                state[:, c + 1:] = state[:, c:c + 1]
            break
        n = torch.clamp(counts - c0, 0, G_CHUNK)
        visited += torch.where(live, n, torch.zeros_like(n))
        blk = params[:, c0:c0 + G_CHUNK]                     # [T, G, R]
        dx = lx[None, None, :] - (blk[..., 0:1] - tox[:, :, None])
        dy = ly[None, None, :] - (blk[..., 1:2] - toy[:, :, None])
        power = _slot_power(blk, dx, dy)                      # [T, G, P]
        araw = blk[..., 5:6] * torch.exp(power)
        use = live[:, None, None] & (power <= 0.0) & (araw >= ALPHA_MIN)
        alpha = torch.where(use, torch.clamp(araw, max=ALPHA_MAX),
                            torch.zeros_like(araw))
        used += int(use.sum())
        cp = torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        wgt = alpha * t_excl * Tr[:, None, :]                 # [T, G, P]
        cols = [blk[..., 6], blk[..., 7], blk[..., 8],
                torch.ones_like(blk[..., 5])]
        for row, col in enumerate(cols):
            acc[:, row] += torch.einsum("tg,tgp->tp", col, wgt)
        if R > 9:
            acc[:, 5] += torch.einsum("tg,tgp->tp", blk[..., 9], wgt)
        Tr = Tr * cp[:, -1]
    acc[:, 4] = Tr
    return acc, visited, used, state


def _slot_power(blk, dx, dy):
    """The power of each (slot, pixel) pair: -0.5 (A dx² + C dy²) - B dx dy
    taken as K2 and K2ᵇ take it (``csrc/composite_common.cuh``), one
    rounding an operation, ((nA dx) dx + (nC dy) dy) + (nB dx) dy with the
    conic pre-scaled (nA = -A/2, nB = -B, nC = -C/2; halving and negating
    are exact)."""
    nA, nB, nC = -0.5 * blk[..., 2:3], -blk[..., 3:4], -0.5 * blk[..., 4:5]
    return nA * dx * dx + nC * dy * dy + nB * dx * dy


def composite_reference(params, counts, tile_h, tile_w, tiles_x,
                        return_state=False):
    """Plain version of K2: params [T, MPT, R], counts [T] -> [T, 8, P];
    with ``return_state``, (out, state [T, MPT/128, 6, P]) as K2 writes
    them."""
    out, _, _, state = _composite_plain(params, counts, tile_h, tile_w,
                                        tiles_x, return_state)
    return (out, state) if return_state else out


def composite_work(params, counts, tile_h, tile_w, tiles_x) -> dict:
    """The data-dependent work of K2 on these inputs, which its bound is
    counted from: ``pairs``, the (pixel, slot) pairs the chunk loop
    visits (one exp each), ``used``, those that pass the alpha test and
    accumulate, ``slots``, the slot rows staged, and ``tile_slots`` [T],
    the slots each tile visits (a tile's live 128-slot chunks are
    ``ceil(tile_slots / 128)``)."""
    _, visited, used, _ = _composite_plain(params, counts, tile_h, tile_w,
                                           tiles_x)
    slots = int(visited.sum())
    return {"pairs": slots * tile_h * tile_w, "used": used, "slots": slots,
            "tile_slots": visited}


def _counted(kernel: str, params: torch.Tensor, written: int):
    """In a profiled run, count a launch of ``kernel`` and the bytes its
    shapes fix (each tile's count read, ``written`` f32 values a tile
    written), and return the device slots its data's (pairs, bytes) are
    added to; else None."""
    work = trace.device_counters(kernel, params.device)
    if work is not None:
        trace.add(f"{kernel}.launches", 1)
        trace.add(f"{kernel}.bytes", 4 * params.shape[0] * (1 + written))
    return work


def _bwd_work(counts, state, P: int, R: int) -> torch.Tensor:
    """K2ᵇ's (pairs, bytes) from its data, as its blocks count them: a
    (tile, chunk) block below the tile's count reads its state's T row; a
    live one (its vote on that T passes) also the rest of its state and
    its slots' rows, visits slots x P pairs and, in the tile's first chunk,
    reads fo's and go's rows 0-5."""
    counts = counts.long()[:, None]
    c0 = torch.arange(state.shape[1], device=counts.device) * G_CHUNK
    below = c0 < counts
    live = below & (state[:, :, 0].amax(dim=-1) > T_EPS)
    slots = (torch.clamp(counts - c0, 0, G_CHUNK) * live).sum()
    rows = below.sum() + 5 * live.sum() + 12 * live[:, 0].sum()
    return torch.stack([slots * P, 4 * (slots * R + rows * P)])


def composite_fwd(params: torch.Tensor, counts: torch.Tensor, tile_h: int,
                  tile_w: int, tiles_x: int, return_state: bool = False):
    """K2 on a CUDA tensor, ``composite_reference`` on a CPU tensor. With
    ``return_state`` it also writes the pixel state at every chunk
    boundary, which ``composite_bwd`` starts its blocks from, and returns
    (out, state). A profiled call counts (``_counted``) its launch, its
    fixed bytes and, from the data, the pairs it visits and its slots'
    rows."""
    T, MPT, R = params.shape
    P = tile_h * tile_w
    # The output and, where asked, the state at every boundary.
    written = 8 * P + (MPT // G_CHUNK * 6 * P if return_state else 0)
    if params.device.type == "cpu":
        work = _counted("composite_fwd", params, written)
        out, visited, _, state = _composite_plain(
            params, counts, tile_h, tile_w, tiles_x, return_state)
        if work is not None:
            slots = visited.sum()
            work += torch.stack([slots * P, slots * (R * 4)])
        return (out, state) if return_state else out
    if params.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {params.device}")
    if torch.is_grad_enabled() and params.requires_grad:
        raise NotImplementedError(
            "composite_fwd has no gradient of its own: call composite(), "
            "whose backward is K2ᵇ")
    _check_kernel_inputs("composite_fwd", params, counts, tile_h, tile_w)
    if params.data_ptr() % 16:
        raise ValueError("composite_fwd kernel copies params in 16-byte "
                         "units: its data must be 16-byte aligned")
    cluster, ppt = launch_shape(P, K2_VARIANT)
    out = torch.empty(T, 8, P, dtype=torch.float32, device=params.device)
    state = (torch.empty(T, MPT // G_CHUNK, 6, P, dtype=torch.float32,
                         device=params.device) if return_state else None)
    lib = _build.load("composite_fwd", _SIGNATURES)
    work = _counted("composite_fwd", params, written)
    err = lib.composite_fwd_f32(
        params.data_ptr(), counts.data_ptr(), out.data_ptr(),
        state.data_ptr() if return_state else None,
        work.data_ptr() if work is not None else None, T, MPT, R, tile_h,
        tile_w, tiles_x, cluster, ppt,
        torch.cuda.current_stream(params.device).cuda_stream,
        params.device.index)
    _build.check(lib, err, "composite_fwd")
    composite_fwd.launches += 1
    return (out, state) if return_state else out


composite_fwd.launches = 0


def _check_kernel_inputs(what, params, counts, tile_h, tile_w, named=()):
    T, MPT, R = params.shape
    P = tile_h * tile_w
    if (params.dtype != torch.float32 or not params.is_contiguous()
            or R not in (9, 10) or P > 1024 or P % 32 or MPT % G_CHUNK):
        raise ValueError(
            f"{what} kernel takes contiguous f32 params [T, MPT, R] with R "
            f"in (9, 10), MPT % {G_CHUNK} == 0 and a multiple of 32 pixels "
            f"per tile, at most 1024; got {params.dtype} "
            f"{tuple(params.shape)}, tile {tile_h}x{tile_w}")
    if (counts.dtype != torch.int32 or counts.shape != (T,)
            or counts.device != params.device or not counts.is_contiguous()):
        raise ValueError(f"{what}: counts must be a contiguous int32 [{T}] "
                         f"tensor on {params.device}")
    for name, x in named:
        if (x.dtype != torch.float32 or x.shape != (T, 8, P)
                or x.device != params.device or not x.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous f32 "
                             f"[{T}, 8, {P}] tensor on {params.device}")


def composite_bwd_reference(params, counts, fo, go, tile_h, tile_w,
                            tiles_x, state=None):
    """Plain version of K2ᵇ: the VJP of K2 at ``params`` for the output
    cotangent ``go`` [T, 8, P], given K2's output ``fo``. Returns dparams
    like params [T, MPT, R].

    The arithmetic of ``lgm_tpu/ops/gsplat/flatsort.py::_bwd_tile``:
    front-to-back replay with the forward's chunking and tile-wide
    early-out; s = Σ_c go_c·col_c; the suffix Σ_{j>i} s_j w_j + gT·T_final
    as U_eff − prefix(u) (U_eff folds in gT·T_final); dalpha = s·T_i −
    suffix / max(1 − α, 0.01) where α > 0, else 0; dpower = dalpha·α where
    op·e < 0.99 (unclamped), else 0. It takes the gradient of the tile-local
    quadratic directly in (x̄, ȳ, A, B, C) — the same numbers as chaining
    lgm_tpu's coefficient cotangents, without their cancellation — and
    dop = Σ_p dpower / max(op, 1e-12), dcol = Σ_p go·w, in plain f32.

    Without ``state`` every chunk starts from the previous one's end (the
    replay). Given K2's ``state`` [T, MPT/128, 6, P], each chunk starts
    on its own from the transmittance stored at its boundary and the
    prefix Σ_c go_c·acc_c of the stored accumulators, and is live where
    it starts inside the tile's count and the stored transmittance passes
    the forward's vote: the kernel's schedule. The chunks are then taken
    last to first, which gives the same result, since none reads
    another's."""
    T, MPT, R = params.shape
    P = tile_h * tile_w
    dev = params.device
    pix = torch.arange(P, device=dev)
    tid = torch.arange(T, device=dev)
    geo = dict(
        lx=(pix % tile_w).float(),
        ly=torch.div(pix, tile_w, rounding_mode="floor").float(),
        tox=((tid % tiles_x) * tile_w).float()[:, None, None],
        toy=(torch.div(tid, tiles_x, rounding_mode="floor") * tile_h
             ).float()[:, None, None],
        # U_eff: channels r, g, b, alpha, depth, plus gT * T_final (row 4).
        u_eff=((go[:, 0:6] * fo[:, 0:6]).sum(dim=1))[:, None, :],
        gcol=go[:, None, :, :])                                  # [T,1,8,P]
    counts = counts.long()
    dparams = torch.zeros_like(params)
    chunks = range(0, MPT, G_CHUNK)
    if state is None:
        Tr = torch.ones(T, 1, P, dtype=params.dtype, device=dev)
        pref = torch.zeros_like(Tr)
        for c0 in chunks:
            live = (c0 < counts) & (Tr.amax(dim=(1, 2)) > T_EPS)       # [T]
            if not bool(live.any()):
                break
            Tr, pref = _bwd_chunk(params, dparams, c0, live, Tr, pref, geo)
        return dparams
    # Rows of go that weigh the stored accumulators r, g, b, alpha, depth.
    g_acc = go[:, [0, 1, 2, 3, 5]]                                # [T,5,P]
    for c0 in reversed(chunks):
        st = state[:, c0 // G_CHUNK]                                # [T,6,P]
        Tr = st[:, 0:1]
        live = (c0 < counts) & (Tr.amax(dim=(1, 2)) > T_EPS)
        if bool(live.any()):
            pref = (g_acc * st[:, 1:6]).sum(dim=1, keepdim=True)
            _bwd_chunk(params, dparams, c0, live, Tr, pref, geo)
    return dparams


def _bwd_chunk(params, dparams, c0, live, Tr, pref, geo):
    """One 128-slot chunk of the plain K2ᵇ for every tile, from each
    pixel's transmittance ``Tr`` and prefix ``pref`` [T, 1, P] at its
    start; ``live`` [T] marks the tiles that composite it. Writes the
    chunk's rows of ``dparams`` and returns (Tr, pref) at its end."""
    R = params.shape[2]
    gcol = geo["gcol"]
    blk = params[:, c0:c0 + G_CHUNK]                                 # [T,G,R]
    A, B, C = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
    op = blk[..., 5:6]
    dx = geo["lx"] - (blk[..., 0:1] - geo["tox"])                    # [T,G,P]
    dy = geo["ly"] - (blk[..., 1:2] - geo["toy"])
    power = _slot_power(blk, dx, dy)
    araw = op * torch.exp(power)
    use = live[:, None, None] & (power <= 0.0) & (araw >= ALPHA_MIN)
    alpha = torch.where(use, torch.clamp(araw, max=ALPHA_MAX),
                        torch.zeros_like(araw))
    om = 1.0 - alpha
    cp = torch.cumprod(om, dim=1)
    t_i = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1) * Tr
    w = alpha * t_i
    s = (blk[..., 6:7] * gcol[:, :, 0] + blk[..., 7:8] * gcol[:, :, 1]
         + blk[..., 8:9] * gcol[:, :, 2] + gcol[:, :, 3])
    if R > 9:
        s = s + blk[..., 9:10] * gcol[:, :, 5]
    pref_i = pref + torch.cumsum(s * w, dim=1)
    dalpha = s * t_i - (geo["u_eff"] - pref_i) / torch.clamp(
        om, min=1.0 - ALPHA_MAX)
    dalpha = torch.where(alpha > 0.0, dalpha, torch.zeros_like(dalpha))
    dpower = torch.where(araw < ALPHA_MAX, dalpha * alpha,
                         torch.zeros_like(dalpha))
    rows = [
        (dpower * (A * dx + B * dy)).sum(-1),        # d x̄
        (dpower * (C * dy + B * dx)).sum(-1),        # d ȳ
        (-0.5 * dpower * dx * dx).sum(-1),           # d A
        (-dpower * dx * dy).sum(-1),                 # d B
        (-0.5 * dpower * dy * dy).sum(-1),           # d C
        dpower.sum(-1) / torch.clamp(op[..., 0], min=1e-12),   # d op
    ]
    rows += [(gcol[:, :, c] * w).sum(-1) for c in (0, 1, 2)]
    if R > 9:
        rows.append((gcol[:, :, 5] * w).sum(-1))
    dparams[:, c0:c0 + G_CHUNK] = torch.stack(rows, dim=-1)
    return Tr * cp[:, -1:], pref_i[:, -1:]


def composite_bwd(params, counts, fo, go, tile_h: int, tile_w: int,
                  tiles_x: int, state=None) -> torch.Tensor:
    """K2ᵇ on CUDA tensors, fed K2's ``state`` (``composite_fwd(...,
    return_state=True)``), which it requires; ``composite_bwd_reference``
    on CPU tensors, with or without the state. A profiled call counts
    (``_counted``) its launch, its fixed bytes and, from the data, what
    ``_bwd_work`` says."""
    T, MPT, R = params.shape
    P = tile_h * tile_w
    if params.device.type == "cpu":
        # Every gradient row is written.
        work = _counted("composite_bwd", params, MPT * R)
        if work is not None:
            work += _bwd_work(counts, state if state is not None else
                              _composite_plain(params, counts, tile_h, tile_w,
                                               tiles_x, True)[3], P, R)
        return composite_bwd_reference(params, counts, fo, go, tile_h,
                                       tile_w, tiles_x, state)
    if params.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {params.device}")
    _check_kernel_inputs("composite_bwd", params, counts, tile_h, tile_w,
                         (("fo", fo), ("go", go)))
    nc = MPT // G_CHUNK
    if (state is None or state.dtype != torch.float32
            or state.shape != (T, nc, 6, P) or state.device != params.device
            or not state.is_contiguous()):
        raise ValueError(
            f"composite_bwd kernel starts each (tile, chunk) block from K2's "
            f"state: a contiguous f32 [{T}, {nc}, 6, {P}] tensor on "
            f"{params.device} from composite_fwd(..., return_state=True)")
    dparams = torch.empty_like(params)
    lib = _build.load("composite_bwd", _BWD_SIGNATURES)
    work = _counted("composite_bwd", params, MPT * R)
    err = lib.composite_bwd_f32(
        params.data_ptr(), counts.data_ptr(), fo.data_ptr(), go.data_ptr(),
        state.data_ptr(), dparams.data_ptr(),
        work.data_ptr() if work is not None else None, T, MPT, R, tile_h,
        tile_w, tiles_x, torch.cuda.current_stream(params.device).cuda_stream,
        params.device.index)
    _build.check(lib, err, "composite_bwd")
    composite_bwd.launches += 1
    return dparams


composite_bwd.launches = 0


class _Composite(torch.autograd.Function):
    """K2 forward, K2ᵇ backward; residuals params, counts, the output
    (``_cf_fwd``) and K2's chunk-boundary state."""

    @staticmethod
    def forward(ctx, params, counts, tile_h, tile_w, tiles_x):
        out, state = composite_fwd(params, counts, tile_h, tile_w, tiles_x,
                                   return_state=True)
        ctx.save_for_backward(params, counts, out, state)
        ctx.tiling = (tile_h, tile_w, tiles_x)
        return out

    @staticmethod
    def backward(ctx, go):
        params, counts, out, state = ctx.saved_tensors
        with trace.span("render.composite.backward"):
            dparams = composite_bwd(params, counts, out, go.contiguous(),
                                    *ctx.tiling, state=state)
        return dparams, None, None, None, None


def composite(params, counts, tile_h: int, tile_w: int,
              tiles_x: int) -> torch.Tensor:
    """The per-tile composite with a gradient: ``composite_fwd``, and
    ``composite_bwd`` on the way back when autograd records the call (the
    forward then writes the state the backward starts from)."""
    if torch.is_grad_enabled() and params.requires_grad:
        return _Composite.apply(params, counts, tile_h, tile_w, tiles_x)
    return composite_fwd(params, counts, tile_h, tile_w, tiles_x)


def _pack_output(out, bg_color, image_size, tile_h, tile_w, with_depth):
    """[T, 8, P] composite output -> dict of image [S, S, 3] (unclamped),
    alpha [S, S] and, with depth, depth [S, S]."""
    S = image_size
    tiles_y, tiles_x = S // tile_h, S // tile_w
    out = out.reshape(tiles_y, tiles_x, 8, tile_h, tile_w)
    out = out.permute(0, 3, 1, 4, 2).reshape(S, S, 8)
    rgb, alpha, Tf = out[..., 0:3], out[..., 3], out[..., 4]
    result = {"image": rgb + Tf[..., None] * bg_color[None, None, :],
              "alpha": alpha}
    if with_depth:
        result["depth"] = out[..., 5]
    return result


def render_flatsort(gaussians, view, image_size, tan_half_fov, bg_color,
                    scale_modifier=1.0, tile_h=32, tile_w=32, dup=16,
                    max_per_tile=1024, with_depth=True):
    """Render one view [N, 14] x [4, 4] via the flat-sort pipeline."""
    params, counts = _prepare_view(
        gaussians, view, image_size, tan_half_fov, scale_modifier, tile_h,
        tile_w, dup, max_per_tile, with_depth)
    with trace.span("render.composite"):
        out = composite(params, counts, tile_h, tile_w, image_size // tile_w)
    return _pack_output(out, bg_color, image_size, tile_h, tile_w,
                        with_depth)


def render_views_flatsort(gaussians, cam_view, image_size, tan_half_fov, bg,
                          scale_modifier=1.0, tile_h=32, tile_w=32, dup=16,
                          max_per_tile=1024, with_depth=True):
    """All [B, V] views of [B, N, 14] Gaussians, one view at a time (one
    K2 launch per view, as the TPU's lax.map runs one view per step).
    ``bg`` is [B, V, 3]. Returns NHWC image [B, V, S, S, 3], alpha and
    depth [B, V, S, S]."""
    B, V = cam_view.shape[:2]
    views = [render_flatsort(gaussians[b], cam_view[b, v], image_size,
                             tan_half_fov, bg[b, v], scale_modifier, tile_h,
                             tile_w, dup, max_per_tile, with_depth)
             for b in range(B) for v in range(V)]
    return stack_views(views, B, V)


def stack_views(views, B: int, V: int):
    """B*V per-view dicts of [S, S(, k)] -> one dict of [B, V, S, S(, k)]."""
    return {key: torch.stack([o[key] for o in views]).reshape(
        (B, V) + views[0][key].shape) for key in views[0]}
