"""Tiled Gaussian rasterizer (v1): host-side binning and kernels K3, K3ᵇ.

Port of ``lgm_tpu/ops/gsplat/tiled.py``, the backend ``render_views``
names ``"pallas_v1"``. Per view:

1. ``project`` (``projection.py``: the projection kernels on a CUDA
   tensor, ``project_gaussians`` on a CPU tensor) and one stable depth
   ``argsort``.
2. ``_bin_tiles`` without gradient (as lgm_tpu's ``stop_gradient``): each
   tile keeps, in depth order, the first ``max_per_tile`` splats whose
   scalar 3σ box (``radius`` on both axes, not flatsort's per-axis
   extent) covers it; ``idx`` [T, K] pads with N, ``counts`` [T] caps at
   K.
3. ``_build_tile_params``: gather the slots' rows (index N is a zero pad
   row) and pack the ``[T, 16, K]`` coefficient matrix, whose quadratic is
   *expanded* against tile-local pixel features (x², y², xy, x, y, 1).
   The gradient of the gather is a scatter-add onto the depth-ordered
   rows, that of the depth order an inverse gather (flatsort's two
   autograd Functions).
4. ``tile_composite``: kernel K3 (``csrc/tiled_fwd.cu``) forward and K3ᵇ
   (``csrc/tiled_bwd.cu``) backward on CUDA tensors, their plain versions
   ``tile_composite_reference`` / ``tile_composite_bwd_reference`` on CPU
   tensors. The backward saves params_tiles, counts, pf and the output, as
   ``_tc_fwd`` does, and K3's pixel state at every 128-slot chunk boundary
   (``[T, K/128, 5, P]``: T and the sums r, g, b, alpha), which K3 writes
   only when asked: K3ᵇ runs one block per (tile, chunk), each starting
   from its chunk's stored state.
5. ``[T, P, 8]`` -> image (unclamped, ``rgb + T * bg``) and alpha; this
   backend has no depth channel.

The power of a (pixel, slot) pair is one fixed sequence of f32 roundings,
``((((f0 c0 + f1 c1) + f2 c2) + f3 c3) + f4 c4) + f5 c5`` with every
product and sum rounded on its own, in the kernels and in the plain
versions alike. The expanded quadratic cancels large terms, and the
function jumps where power crosses 0 (α drops from op to 0) and where
op·e^power crosses 1/255; K3ᵇ replays K3's decisions, so both must see the
same bits, which a compiler's choice of fused multiply-adds would not
promise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lgm_tpu_torch.ops import _build
from lgm_tpu_torch.ops.gsplat.flatsort import (_GatherRows, _PermuteRows,
                                                _tile_bboxes_xy, launch_shape,
                                                stack_views)
from lgm_tpu_torch.ops.gsplat.projection import (ALPHA_MAX, ALPHA_MIN,
                                                  project)

# Slots per compositing chunk (the TPU's lane width; the kernels' staging
# unit), the transmittance early-out threshold, the packed matrix's rows,
# the rows of the chunk-boundary state (T, r, g, b, alpha).
G_CHUNK = 128
T_EPS = 1e-4
N_ROWS = 16
STATE_ROWS = 5
# K3's launch shape at 32 x 32 tiles, (cluster size, pixels a thread), as
# flatsort.K2_VARIANT: chosen by measurement (PERF.md): within 2% of
# the fastest on the heavy frame-0 view (as the training step's views),
# 4-7% behind (2, 2) on the bench view.
K3_VARIANT = (4, 2)

_FWD_SIGNATURES = {
    "tiled_fwd_f32": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}
_BWD_SIGNATURES = {
    "tiled_bwd_f32": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_int],
        ctypes.c_int,
    ),
}


# ---------------------------------------------------------------------------
# Pass 1 (plain PyTorch): binning and per-tile coefficient construction
# ---------------------------------------------------------------------------


def _tile_bboxes(mean2d, radius, tile_h, tile_w, tiles_y, tiles_x):
    """Inclusive-exclusive tile ranges covered by each splat's 3σ box."""
    return _tile_bboxes_xy(mean2d, radius, radius, tile_h, tile_w, tiles_y,
                           tiles_x)


def _bin_tiles(active, bbox, tiles_y: int, tiles_x: int, max_per_tile: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-ordered per-tile index lists. The inputs are in depth order,
    so a tile's first K covering splats are its nearest K. Returns (idx
    [T, K] int64 into the sorted arrays, N where a list is shorter, counts
    [T] int32 capped at K)."""
    x0, x1, y0, y1 = bbox
    N = active.shape[0]
    T, K = tiles_y * tiles_x, max_per_tile
    dev = active.device
    tx = torch.arange(tiles_x, device=dev)[:, None]
    ty = torch.arange(tiles_y, device=dev)[:, None]
    in_x = (x0[None, :] <= tx) & (tx < x1[None, :]) & active[None, :]
    in_y = (y0[None, :] <= ty) & (ty < y1[None, :])
    mask = (in_y[:, None, :] & in_x[None, :, :]).reshape(T, N)
    total = mask.sum(dim=1)
    # nonzero lists the pairs tile-major, splats ascending within a tile:
    # a pair's position in its tile's list is its index minus the tile's
    # first.
    tile, splat = torch.nonzero(mask, as_tuple=True)
    pos = torch.arange(tile.shape[0], device=dev) - (
        torch.cumsum(total, 0) - total)[tile]
    keep = pos < K
    idx = torch.full((T, K), N, dtype=torch.long, device=dev)
    idx[tile[keep], pos[keep]] = splat[keep]
    return idx, torch.clamp(total, max=K).to(torch.int32)


def _build_tile_params(proj_sorted, idx, tiles_x: int, tile_h: int,
                       tile_w: int) -> torch.Tensor:
    """Gather per-tile splats and pack the [T, 16, K] coefficient matrix.

    Row layout (pixel features are tile-local):
      0: -A/2   1: -C/2   2: -B          (conic a, b, c = A, B, C)
      3: A·mx + B·my      4: C·my + B·mx
      5: -(A·mx² + C·my²)/2 - B·mx·my    (pairs with the constant-1 feature)
      6: opacity  7: 0
      8..10: rgb  11: 1 (alpha-accumulation column)  12..15: 0
    """
    mean2d, conic, color, opacity = proj_sorted
    T, K = idx.shape
    rows = torch.cat([mean2d, conic, color, opacity[:, None]], dim=1)
    # Index N gathers the zero pad row: alpha == 0 in the composite.
    rows = torch.cat([rows, torch.zeros_like(rows[:1])], dim=0)
    slot = _GatherRows.apply(rows, idx.reshape(-1)).reshape(T, K, 9)

    tid = torch.arange(T, device=idx.device)
    tx = ((tid % tiles_x) * tile_w).float()[:, None]
    ty = (torch.div(tid, tiles_x, rounding_mode="floor") * tile_h
          ).float()[:, None]
    mx = slot[..., 0] - tx
    my = slot[..., 1] - ty
    A, B, C = slot[..., 2], slot[..., 3], slot[..., 4]
    op = slot[..., 8]
    zeros = torch.zeros_like(op)
    return torch.stack([
        -0.5 * A,
        -0.5 * C,
        -B,
        A * mx + B * my,
        C * my + B * mx,
        -(0.5 * A * mx * mx + 0.5 * C * my * my + B * mx * my),
        op,
        zeros,
        slot[..., 5],
        slot[..., 6],
        slot[..., 7],
        torch.ones_like(op),
        zeros,
        zeros,
        zeros,
        zeros,
    ], dim=1)


def _pixel_features(tile_h: int, tile_w: int, device=None) -> torch.Tensor:
    """[P, 8] per-pixel features in tile-local coordinates, the same for
    every tile: (x², y², xy, x, y, 1, 0, 0)."""
    pix = torch.arange(tile_h * tile_w, device=device)
    x = (pix % tile_w).float()
    y = torch.div(pix, tile_w, rounding_mode="floor").float()
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    return torch.stack([x * x, y * y, x * y, x, y, one, zero, zero], dim=-1)


# ---------------------------------------------------------------------------
# The composite: plain versions, kernel wrappers, autograd
# ---------------------------------------------------------------------------


def _chunk_alpha(pf, blk, live):
    """One chunk's [T, P, G] block for all tiles: (alpha, raw alpha,
    e^power), alpha zero outside ``live`` tiles and where culled. The
    power is the fixed sequence of roundings the kernels take."""
    power = pf[None, :, 0:1] * blk[:, None, 0]
    for k in range(1, 6):
        power = power + pf[None, :, k:k + 1] * blk[:, None, k]
    e = torch.exp(power)
    araw = blk[:, None, 6] * e
    use = live[:, None, None] & (power <= 0.0) & (araw >= ALPHA_MIN)
    alpha = torch.where(use, torch.clamp(araw, max=ALPHA_MAX),
                        torch.zeros_like(araw))
    return alpha, araw, e


def _live_chunks(counts, transmittance, c0: int):
    """Tiles that composite the chunk starting at slot ``c0``: it starts
    inside the tile's list and some pixel's transmittance is above T_EPS.
    Decided at the chunk boundary, for the whole tile."""
    return (c0 < counts) & (transmittance.amax(dim=1) > T_EPS)


def _composite_plain(params_tiles, counts, pf, with_state=False):
    """K3's function in plain PyTorch, all tiles at once, chunk by chunk.
    Returns (out [T, P, 8], chunks [T], used, state): ``chunks`` counts the
    chunks each tile composited, ``used`` the (pixel, slot) pairs that
    passed the alpha test, and ``state`` (None unless ``with_state``) is
    K3's ``[T, K/128, 5, P]``: at the boundary before each chunk, each
    pixel's transmittance and its sums r, g, b, alpha; past the chunks a
    tile composites, the tile's final values."""
    T, _, K = params_tiles.shape
    P = pf.shape[0]
    dev, dtype = params_tiles.device, params_tiles.dtype
    counts = counts.long()
    Tr = torch.ones(T, P, dtype=dtype, device=dev)
    acc = torch.zeros(T, P, 8, dtype=dtype, device=dev)
    chunks = torch.zeros_like(counts)
    used = 0
    state = (torch.empty(T, K // G_CHUNK, STATE_ROWS, P, dtype=dtype,
                         device=dev) if with_state else None)
    for c0 in range(0, K, G_CHUNK):
        c = c0 // G_CHUNK
        if state is not None:
            state[:, c, 0] = Tr
            state[:, c, 1:5] = acc[..., 0:4].transpose(1, 2)
        live = _live_chunks(counts, Tr, c0)
        if not bool(live.any()):
            if state is not None:
                state[:, c + 1:] = state[:, c:c + 1]
            break
        chunks += live
        blk = params_tiles[:, :, c0:c0 + G_CHUNK]            # [T, 16, G]
        alpha, _, _ = _chunk_alpha(pf, blk, live)            # [T, P, G]
        used += int((alpha > 0).sum())
        cp = torch.cumprod(1.0 - alpha, dim=2)
        t_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]],
                           dim=2)
        w = alpha * t_excl * Tr[:, :, None]
        acc[..., 0:3] += torch.matmul(w, blk[:, 8:11].transpose(1, 2))
        acc[..., 3] += w.sum(dim=2)
        Tr = Tr * cp[..., -1]
    acc[..., 4] = Tr
    return acc, chunks, used, state


def _check_inputs(what, params_tiles, counts, pf, named=()):
    T, R, K = params_tiles.shape
    P = pf.shape[0]
    dev = params_tiles.device
    if (params_tiles.dtype != torch.float32 or R != N_ROWS or K % G_CHUNK
            or not params_tiles.is_contiguous()):
        raise ValueError(
            f"{what} takes contiguous f32 params_tiles [T, {N_ROWS}, K] "
            f"with K % {G_CHUNK} == 0; got {params_tiles.dtype} "
            f"{tuple(params_tiles.shape)}")
    if (pf.dtype != torch.float32 or pf.shape != (P, 8) or pf.device != dev
            or not pf.is_contiguous() or P > 1024 or P % 32):
        raise ValueError(
            f"{what}: pf must be a contiguous f32 [P, 8] tensor on {dev} "
            f"with P a multiple of 32, at most 1024; "
            f"got {pf.dtype} {tuple(pf.shape)} on {pf.device}")
    if (counts.dtype != torch.int32 or counts.shape != (T,)
            or counts.device != dev or not counts.is_contiguous()):
        raise ValueError(f"{what}: counts must be a contiguous int32 [{T}] "
                         f"tensor on {dev}")
    for name, x in named:
        if (x.dtype != torch.float32 or x.shape != (T, P, 8)
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous f32 "
                             f"[{T}, {P}, 8] tensor on {dev}")


def tile_composite_reference(params_tiles, counts, pf, return_state=False):
    """Plain version of K3: params_tiles [T, 16, K], counts [T], pf [P, 8]
    -> [T, P, 8] (cols 0-2 rgb, 3 alpha, 4 final T, 5-7 zero); with
    ``return_state``, (out, state [T, K/128, 5, P]) as K3 writes them."""
    out, _, _, state = _composite_plain(params_tiles, counts, pf,
                                        return_state)
    return (out, state) if return_state else out


def tile_composite_work(params_tiles, counts, pf) -> dict:
    """The data-dependent work of K3 and K3ᵇ on these inputs, which their
    bounds are counted from: ``chunks``, the 128-slot chunks composited
    over all tiles, ``pairs``, the (pixel, slot) pairs they hold (one exp
    each), ``used``, the pairs that pass the alpha test, and
    ``tile_chunks`` [T], the chunks each tile composites."""
    _, chunks, used, _ = _composite_plain(params_tiles, counts, pf)
    n = int(chunks.sum())
    return {"chunks": n, "pairs": n * G_CHUNK * pf.shape[0], "used": used,
            "tile_chunks": chunks}


def tile_composite_fwd(params_tiles, counts, pf, return_state=False):
    """K3 on CUDA tensors, ``tile_composite_reference`` on CPU tensors.
    Rows 7 and 11-15 of params_tiles and columns 6-7 of pf are the
    layout's constants (0, 1, 0...) and are not read. With
    ``return_state`` it also writes the pixel state at every chunk
    boundary, which ``tile_composite_bwd`` starts its blocks from, and
    returns (out, state)."""
    if params_tiles.device.type == "cpu":
        return tile_composite_reference(params_tiles, counts, pf,
                                        return_state)
    if params_tiles.device.type != "cuda":
        raise ValueError(
            f"tile_composite_fwd: unsupported device {params_tiles.device}")
    if torch.is_grad_enabled() and params_tiles.requires_grad:
        raise NotImplementedError(
            "tile_composite_fwd has no gradient of its own: call "
            "tile_composite(), whose backward is K3ᵇ")
    _check_inputs("tile_composite_fwd", params_tiles, counts, pf)
    T, _, K = params_tiles.shape
    P = pf.shape[0]
    cluster, ppt = launch_shape(P, K3_VARIANT)
    out = torch.empty(T, P, 8, dtype=torch.float32,
                      device=params_tiles.device)
    state = (torch.empty(T, K // G_CHUNK, STATE_ROWS, P, dtype=torch.float32,
                         device=params_tiles.device)
             if return_state else None)
    lib = _build.load("tiled_fwd", _FWD_SIGNATURES)
    err = lib.tiled_fwd_f32(
        params_tiles.data_ptr(), counts.data_ptr(), pf.data_ptr(),
        out.data_ptr(), state.data_ptr() if return_state else None, T, K, P,
        cluster, ppt,
        torch.cuda.current_stream(params_tiles.device).cuda_stream,
        params_tiles.device.index)
    _build.check(lib, err, "tiled_fwd")
    tile_composite_fwd.launches += 1
    return (out, state) if return_state else out


tile_composite_fwd.launches = 0


def tile_composite_bwd_reference(params_tiles, counts, pf, fo, go,
                                 state=None):
    """Plain version of K3ᵇ: the VJP of K3 at ``params_tiles`` for the
    output cotangent ``go`` [T, P, 8], given K3's output ``fo``. Returns
    dparams [T, 16, K].

    The arithmetic of ``lgm_tpu/ops/gsplat/tiled.py::_bwd_kernel``:
    front-to-back replay with the forward's chunking and tile-wide
    early-out; U_total = Σ_{c<4} go_c·fo_c; s = gC·color + gA; the suffix
    Σ_{j>i} s_j w_j as U_total − prefix(u); dalpha = s·T_i − suffix /
    max(1 − α, 0.01) − gT·T_final / max(1 − α, 0.01) where α > 0, else 0;
    dpower = dalpha·α where op·e^power < 0.99, else 0. Rows 0-5 get
    Σ_pixels feature·dpower, row 6 Σ_pixels dalpha·e^power over the
    unclamped pairs, rows 8-10 Σ_pixels gC·w; every other row, and every
    chunk the forward skipped, is zero.

    Without ``state`` every chunk starts from the previous one's end (the
    replay). Given K3's ``state`` [T, K/128, 5, P], each chunk starts on
    its own from the transmittance stored at its boundary and the prefix
    Σ_{c<4} go_c·acc_c of the stored sums, and is live where it starts
    inside the tile's count and the stored transmittance passes the
    forward's vote: the kernel's schedule, taken last chunk first."""
    T, _, K = params_tiles.shape
    P = pf.shape[0]
    dev = params_tiles.device
    counts = counts.long()
    terms = dict(t_final=fo[..., 4:5], g_t=go[..., 4:5],
                 u_total=(go[..., 0:4] * fo[..., 0:4]).sum(dim=2,
                                                           keepdim=True))
    dparams = torch.zeros_like(params_tiles)
    chunks = range(0, K, G_CHUNK)
    if state is None:
        Tr = torch.ones(T, P, dtype=params_tiles.dtype, device=dev)
        pref = torch.zeros(T, P, 1, dtype=params_tiles.dtype, device=dev)
        for c0 in chunks:
            live = _live_chunks(counts, Tr, c0)
            if not bool(live.any()):
                break
            Tr, pref = _bwd_chunk(params_tiles, pf, go, dparams, c0, live,
                                  Tr, pref, terms)
        return dparams
    for c0 in reversed(chunks):
        st = state[:, c0 // G_CHUNK]                               # [T,5,P]
        Tr = st[:, 0]
        live = _live_chunks(counts, Tr, c0)
        if bool(live.any()):
            pref = (go[..., 0:4] * st[:, 1:5].transpose(1, 2)).sum(
                dim=2, keepdim=True)
            _bwd_chunk(params_tiles, pf, go, dparams, c0, live, Tr, pref,
                       terms)
    return dparams


def _bwd_chunk(params_tiles, pf, go, dparams, c0, live, Tr, pref, terms):
    """One 128-slot chunk of the plain K3ᵇ for every tile, from each
    pixel's transmittance ``Tr`` [T, P] and prefix ``pref`` [T, P, 1] at
    its start; ``live`` [T] marks the tiles that composite it. Writes the
    chunk's columns of ``dparams`` and returns (Tr, pref) at its end."""
    blk = params_tiles[:, :, c0:c0 + G_CHUNK]                # [T, 16, G]
    alpha, araw, e = _chunk_alpha(pf, blk, live)             # [T, P, G]
    om = 1.0 - alpha
    cp = torch.cumprod(om, dim=2)
    t_i = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]],
                    dim=2) * Tr[:, :, None]
    w = alpha * t_i
    s = torch.matmul(go[..., 0:3], blk[:, 8:11]) + go[..., 3:4]
    pref_i = pref + torch.cumsum(s * w, dim=2)
    om_safe = torch.clamp(om, min=1.0 - ALPHA_MAX)
    dalpha = (s * t_i - (terms["u_total"] - pref_i) / om_safe
              - terms["g_t"] * terms["t_final"] / om_safe)
    dalpha = torch.where(alpha > 0.0, dalpha, torch.zeros_like(dalpha))
    unclamped = araw < ALPHA_MAX
    dpower = torch.where(unclamped, dalpha * alpha,
                         torch.zeros_like(dalpha))
    dop = torch.where(unclamped, dalpha * e, torch.zeros_like(dalpha))
    out = dparams[:, :, c0:c0 + G_CHUNK]
    out[:, 0:6] = torch.matmul(pf[:, 0:6].T.to(dpower.dtype), dpower)
    out[:, 6] = dop.sum(dim=1)
    out[:, 8:11] = torch.matmul(go[..., 0:3].transpose(1, 2), w)
    return Tr * cp[..., -1], pref_i[..., -1:]


def tile_composite_bwd(params_tiles, counts, pf, fo, go,
                       state=None) -> torch.Tensor:
    """K3ᵇ on CUDA tensors, fed K3's ``state`` (``tile_composite_fwd(...,
    return_state=True)``), which it requires; ``tile_composite_bwd_reference``
    on CPU tensors, with or without the state."""
    if params_tiles.device.type == "cpu":
        return tile_composite_bwd_reference(params_tiles, counts, pf, fo, go,
                                            state)
    if params_tiles.device.type != "cuda":
        raise ValueError(
            f"tile_composite_bwd: unsupported device {params_tiles.device}")
    _check_inputs("tile_composite_bwd", params_tiles, counts, pf,
                  (("fo", fo), ("go", go)))
    T, _, K = params_tiles.shape
    P = pf.shape[0]
    shape = (T, K // G_CHUNK, STATE_ROWS, P)
    if (state is None or state.dtype != torch.float32
            or state.shape != shape or state.device != params_tiles.device
            or not state.is_contiguous()):
        raise ValueError(
            f"tile_composite_bwd kernel starts each (tile, chunk) block from "
            f"K3's state: a contiguous f32 {list(shape)} tensor on "
            f"{params_tiles.device} from tile_composite_fwd(..., "
            f"return_state=True)")
    # The kernel writes rows 0-6 and 8-10 of the slots it replays.
    dparams = torch.zeros_like(params_tiles)
    lib = _build.load("tiled_bwd", _BWD_SIGNATURES)
    err = lib.tiled_bwd_f32(
        params_tiles.data_ptr(), counts.data_ptr(), pf.data_ptr(),
        fo.data_ptr(), go.data_ptr(), state.data_ptr(), dparams.data_ptr(),
        T, K, P, torch.cuda.current_stream(params_tiles.device).cuda_stream,
        params_tiles.device.index)
    _build.check(lib, err, "tiled_bwd")
    tile_composite_bwd.launches += 1
    return dparams


tile_composite_bwd.launches = 0


class _TileComposite(torch.autograd.Function):
    """K3 forward, K3ᵇ backward; residuals params_tiles, counts, pf, the
    output (``_tc_fwd``) and K3's chunk-boundary state."""

    @staticmethod
    def forward(ctx, params_tiles, counts, pf):
        out, state = tile_composite_fwd(params_tiles, counts, pf,
                                        return_state=True)
        ctx.save_for_backward(params_tiles, counts, pf, out, state)
        return out

    @staticmethod
    def backward(ctx, go):
        params_tiles, counts, pf, out, state = ctx.saved_tensors
        return tile_composite_bwd(params_tiles, counts, pf, out,
                                  go.contiguous(), state), None, None


def tile_composite(params_tiles, counts, pf) -> torch.Tensor:
    """Composite binned splats, [T, 16, K] -> [T, P, 8] (rgb | A | T | 0s),
    with a gradient: ``tile_composite_fwd``, and ``tile_composite_bwd`` on
    the way back when autograd records the call (the forward then writes
    the state the backward starts from)."""
    if torch.is_grad_enabled() and params_tiles.requires_grad:
        return _TileComposite.apply(params_tiles, counts, pf)
    return tile_composite_fwd(params_tiles, counts, pf)


# ---------------------------------------------------------------------------
# Per-view and batched entry points
# ---------------------------------------------------------------------------


def _prepare_view(gaussians, view, image_size, tan_half_fov, scale_modifier,
                  tile_h, tile_w, max_per_tile):
    """Projection, depth order, binning and packing for one view: the
    composite's inputs (params_tiles [T, 16, K], counts [T], pf [P, 8])."""
    S = image_size
    if S % tile_h or S % tile_w:
        raise ValueError(f"image size {S} is not a multiple of the "
                         f"{tile_h}x{tile_w} tile")
    if max_per_tile % G_CHUNK:
        raise ValueError(f"max_per_tile must be a multiple of {G_CHUNK}, "
                         f"got {max_per_tile}")
    tiles_y, tiles_x = S // tile_h, S // tile_w

    proj = project(gaussians, view, S, tan_half_fov, scale_modifier)
    with torch.no_grad():
        active = proj.valid & (proj.radius > 0)
        order = torch.argsort(
            torch.where(active, proj.depth,
                        torch.full_like(proj.depth, float("inf"))),
            stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=order.device)
        bbox = _tile_bboxes(proj.mean2d[order], proj.radius[order], tile_h,
                            tile_w, tiles_y, tiles_x)
        idx, counts = _bin_tiles(active[order], bbox, tiles_y, tiles_x,
                                 max_per_tile)
    rows = _PermuteRows.apply(proj.attrs_t.T, order, rank)   # depth order
    params_tiles = _build_tile_params(
        (rows[:, 0:2], rows[:, 2:5], rows[:, 6:9], rows[:, 5]), idx,
        tiles_x, tile_h, tile_w)
    return params_tiles, counts, _pixel_features(tile_h, tile_w,
                                                 gaussians.device)


def render_tiled(gaussians, view, image_size, tan_half_fov, bg_color,
                 scale_modifier=1.0, tile_h=32, tile_w=32,
                 max_per_tile=1024):
    """Render one view [N, 14] x [4, 4] via the tiled pipeline. Returns
    dict(image [S, S, 3] unclamped, alpha [S, S])."""
    S = image_size
    params_tiles, counts, pf = _prepare_view(
        gaussians, view, S, tan_half_fov, scale_modifier, tile_h, tile_w,
        max_per_tile)
    out = tile_composite(params_tiles, counts, pf)           # [T, P, 8]
    out = out.reshape(S // tile_h, S // tile_w, tile_h, tile_w, 8)
    out = out.permute(0, 2, 1, 3, 4).reshape(S, S, 8)
    rgb, alpha, Tf = out[..., 0:3], out[..., 3], out[..., 4]
    return {"image": rgb + Tf[..., None] * bg_color[None, None, :],
            "alpha": alpha}


def render_views_tiled(gaussians, cam_view, image_size, tan_half_fov, bg,
                       scale_modifier=1.0, tile_h=32, tile_w=32,
                       max_per_tile=1024):
    """All [B, V] views of [B, N, 14] Gaussians, one view at a time (one
    K3 launch per view), each view's residuals kept for the backward (the
    [T, 16, K] matrix is 16.8 MB a view at 512², K = 1024), where lgm_tpu
    recomputes pass 1 to save memory. ``bg`` is [B, V, 3]. Returns image
    [B, V, S, S, 3] and alpha [B, V, S, S]."""
    B, V = cam_view.shape[:2]
    views = [render_tiled(gaussians[b], cam_view[b, v], image_size,
                          tan_half_fov, bg[b, v], scale_modifier, tile_h,
                          tile_w, max_per_tile)
             for b in range(B) for v in range(V)]
    return stack_views(views, B, V)
