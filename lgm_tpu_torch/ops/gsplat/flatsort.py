"""Flat-sort Gaussian rasterizer: host-side binning and kernels K2, K2ᵇ.

Port of ``lgm_tpu/ops/gsplat/flatsort.py``. Per view:

1. ``project_gaussians`` (plain PyTorch, SoA).
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
   ``_cf_fwd`` does.
5. ``_pack_output``: [T, 8, P] -> image / alpha / depth.

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

from lgm_tpu_torch.ops import _build
from lgm_tpu_torch.ops.gsplat.projection import (
    ALPHA_MAX,
    ALPHA_MIN,
    log_alpha_min,
    project_gaussians,
)

# Slots per compositing chunk (the TPU's lane width; the kernel's staging
# unit) and the transmittance early-out threshold (the CUDA rasterizer's).
G_CHUNK = 128
T_EPS = 1e-4

_SIGNATURES = {
    "composite_fwd_f32": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_BWD_SIGNATURES = {
    "composite_bwd_f32": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}


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

    proj = project_gaussians(gaussians, view, S, tan_half_fov,
                             scale_modifier)
    with torch.no_grad():
        meta = _flat_binning(proj, tiles_y, tiles_x, tile_h, tile_w, dup,
                             max_per_tile)
    attrs_t = proj.attrs_t
    if with_depth:
        attrs_t = torch.cat([attrs_t, proj.depth[None]], dim=0)
    attrs = _PermuteRows.apply(attrs_t.T, meta.order, meta.rank)
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


def _composite_plain(params, counts, tile_h, tile_w, tiles_x):
    """K2's function in plain PyTorch, all tiles at once, chunk by chunk.
    Returns (out [T, 8, P], visited [T], used): ``visited`` counts the
    slots each tile's chunk loop walked (the kernel's work per pixel),
    ``used`` the (pixel, slot) pairs that passed the alpha test."""
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

    Tr = torch.ones(T, P, device=dev)
    acc = torch.zeros(T, 8, P, device=dev)
    visited = torch.zeros(T, dtype=torch.long, device=dev)
    used = 0
    for c0 in range(0, MPT, G_CHUNK):
        live = (c0 < counts) & (Tr.amax(dim=1) > T_EPS)       # [T]
        if not bool(live.any()):
            break
        n = torch.clamp(counts - c0, 0, G_CHUNK)
        visited += torch.where(live, n, torch.zeros_like(n))
        blk = params[:, c0:c0 + G_CHUNK]                     # [T, G, R]
        dx = lx[None, None, :] - (blk[..., 0:1] - tox[:, :, None])
        dy = ly[None, None, :] - (blk[..., 1:2] - toy[:, :, None])
        power = (-0.5 * (blk[..., 2:3] * dx * dx + blk[..., 4:5] * dy * dy)
                 - blk[..., 3:4] * dx * dy)                   # [T, G, P]
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
    return acc, visited, used


def composite_reference(params, counts, tile_h, tile_w, tiles_x):
    """Plain version of K2: params [T, MPT, R], counts [T] -> [T, 8, P]."""
    return _composite_plain(params, counts, tile_h, tile_w, tiles_x)[0]


def composite_work(params, counts, tile_h, tile_w, tiles_x) -> dict:
    """The data-dependent work of K2 on these inputs, which its bound is
    counted from: ``pairs``, the (pixel, slot) pairs the chunk loop
    visits (one exp each), ``used``, those that pass the alpha test and
    accumulate, and ``slots``, the slot rows staged."""
    _, visited, used = _composite_plain(params, counts, tile_h, tile_w,
                                        tiles_x)
    slots = int(visited.sum())
    return {"pairs": slots * tile_h * tile_w, "used": used, "slots": slots}


def composite_fwd(params: torch.Tensor, counts: torch.Tensor, tile_h: int,
                  tile_w: int, tiles_x: int) -> torch.Tensor:
    """K2 on a CUDA tensor, ``composite_reference`` on a CPU tensor."""
    if params.device.type == "cpu":
        return composite_reference(params, counts, tile_h, tile_w, tiles_x)
    if params.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {params.device}")
    if torch.is_grad_enabled() and params.requires_grad:
        raise NotImplementedError(
            "composite_fwd has no gradient of its own: call composite(), "
            "whose backward is K2ᵇ")
    T, MPT, R = params.shape
    P = tile_h * tile_w
    _check_kernel_inputs("composite_fwd", params, counts, tile_h, tile_w)
    out = torch.empty(T, 8, P, dtype=torch.float32, device=params.device)
    lib = _build.load("composite_fwd", _SIGNATURES)
    err = lib.composite_fwd_f32(
        params.data_ptr(), counts.data_ptr(), out.data_ptr(), T, MPT, R,
        tile_h, tile_w, tiles_x,
        torch.cuda.current_stream(params.device).cuda_stream,
        params.device.index)
    _build.check(lib, err, "composite_fwd")
    composite_fwd.launches += 1
    return out


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
                            tiles_x):
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
    dop = Σ_p dpower / max(op, 1e-12), dcol = Σ_p go·w, in plain f32."""
    T, MPT, R = params.shape
    P = tile_h * tile_w
    dev = params.device
    pix = torch.arange(P, device=dev)
    lx = (pix % tile_w).float()
    ly = torch.div(pix, tile_w, rounding_mode="floor").float()
    tid = torch.arange(T, device=dev)
    tox = ((tid % tiles_x) * tile_w).float()[:, None, None]
    toy = (torch.div(tid, tiles_x, rounding_mode="floor") * tile_h
           ).float()[:, None, None]
    counts = counts.long()
    # U_eff: channels r, g, b, alpha, depth, plus gT * T_final (row 4).
    u_eff = ((go[:, 0:6] * fo[:, 0:6]).sum(dim=1))[:, None, :]   # [T, 1, P]
    gcol = go[:, None, :, :]                                      # [T,1,8,P]

    Tr = torch.ones(T, 1, P, device=dev)
    pref = torch.zeros(T, 1, P, device=dev)
    dparams = torch.zeros_like(params)
    for c0 in range(0, MPT, G_CHUNK):
        live = (c0 < counts) & (Tr.amax(dim=(1, 2)) > T_EPS)          # [T]
        if not bool(live.any()):
            break
        blk = params[:, c0:c0 + G_CHUNK]                             # [T,G,R]
        A, B, C = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
        op = blk[..., 5:6]
        dx = lx - (blk[..., 0:1] - tox)                              # [T,G,P]
        dy = ly - (blk[..., 1:2] - toy)
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
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
        dalpha = s * t_i - (u_eff - pref_i) / torch.clamp(
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
        pref = pref_i[:, -1:]
        Tr = Tr * cp[:, -1:]
    return dparams


def composite_bwd(params, counts, fo, go, tile_h: int, tile_w: int,
                  tiles_x: int) -> torch.Tensor:
    """K2ᵇ on CUDA tensors, ``composite_bwd_reference`` on CPU tensors."""
    if params.device.type == "cpu":
        return composite_bwd_reference(params, counts, fo, go, tile_h,
                                       tile_w, tiles_x)
    if params.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {params.device}")
    T, MPT, R = params.shape
    _check_kernel_inputs("composite_bwd", params, counts, tile_h, tile_w,
                         (("fo", fo), ("go", go)))
    dparams = torch.empty_like(params)
    lib = _build.load("composite_bwd", _BWD_SIGNATURES)
    err = lib.composite_bwd_f32(
        params.data_ptr(), counts.data_ptr(), fo.data_ptr(), go.data_ptr(),
        dparams.data_ptr(), T, MPT, R, tile_h, tile_w, tiles_x,
        torch.cuda.current_stream(params.device).cuda_stream,
        params.device.index)
    _build.check(lib, err, "composite_bwd")
    composite_bwd.launches += 1
    return dparams


composite_bwd.launches = 0


class _Composite(torch.autograd.Function):
    """K2 forward, K2ᵇ backward; residuals params, counts and the output
    (``_cf_fwd``)."""

    @staticmethod
    def forward(ctx, params, counts, tile_h, tile_w, tiles_x):
        out = composite_fwd(params, counts, tile_h, tile_w, tiles_x)
        ctx.save_for_backward(params, counts, out)
        ctx.tiling = (tile_h, tile_w, tiles_x)
        return out

    @staticmethod
    def backward(ctx, go):
        params, counts, out = ctx.saved_tensors
        dparams = composite_bwd(params, counts, out, go.contiguous(),
                                *ctx.tiling)
        return dparams, None, None, None, None


def composite(params, counts, tile_h: int, tile_w: int,
              tiles_x: int) -> torch.Tensor:
    """The per-tile composite with a gradient: ``composite_fwd``, and
    ``composite_bwd`` on the way back when autograd records the call."""
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
