"""The plain Gaussian renderer the benchmark holds the program's to.

A frozen copy of the flat-sort rasterizer's function in plain PyTorch, f32
throughout, differentiated by autograd: EWA projection of the 3D
Gaussians (the 3DGS CUDA rasterizer's formulation that LGM calls), the
opacity-aware per-axis extent, tile binning with the per-splat live-tile
cap ``dup`` and the per-tile cap MPT (the nearest entries kept), then a
front-to-back composite of each tile in 128-slot chunks with the
tile-wide early-out at transmittance 1e-4. No kernel and nothing of the
program: it also makes the benchmark's input views and supervision
images.
"""

from __future__ import annotations

import math

import torch

NEAR_CULL = 0.2
FRUSTUM_CLAMP = 1.3
COV2D_DILATE = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
CHUNK = 128


def project(g: torch.Tensor, view: torch.Tensor, size: int, tan: float):
    """Packed Gaussians [N, 14] (pos, opacity, scale, quat wxyz, rgb)
    through the transposed w2c ``view`` [4, 4]: a dict of [N] / [N, k]
    screen quantities."""
    w2c = view.T
    focal = 0.5 * size / tan
    px, py, pz = g[:, 0], g[:, 1], g[:, 2]
    opacity = g[:, 3]
    sx, sy, sz = g[:, 4], g[:, 5], g[:, 6]
    qw, qx, qy, qz = g[:, 7], g[:, 8], g[:, 9], g[:, 10]
    W = w2c[:3, :3]
    tx = W[0, 0] * px + W[0, 1] * py + W[0, 2] * pz + w2c[0, 3]
    ty = W[1, 0] * px + W[1, 1] * py + W[1, 2] * pz + w2c[1, 3]
    tz = W[2, 0] * px + W[2, 1] * py + W[2, 2] * pz + w2c[2, 3]
    valid = tz > NEAR_CULL
    zs = torch.where(valid, tz, torch.ones_like(tz))
    lim = FRUSTUM_CLAMP * tan
    txz = torch.clamp(tx / zs, -lim, lim) * zs
    tyz = torch.clamp(ty / zs, -lim, lim) * zs
    # The quaternion as given, through the unit-quaternion formula.
    R = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
          2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
          1 - 2 * (qx * qx + qy * qy)]]
    s = (sx, sy, sz)
    M = [[R[i][j] * s[j] for j in range(3)] for i in range(3)]
    cov = [[sum(M[i][k] * M[j][k] for k in range(3)) for j in range(3)]
           for i in range(3)]
    inv_z = 1.0 / zs
    g0 = focal * inv_z
    gx = focal * txz * inv_z * inv_z
    gy = focal * tyz * inv_z * inv_z
    J = [[g0 * W[0, j] - gx * W[2, j] for j in range(3)],
         [g0 * W[1, j] - gy * W[2, j] for j in range(3)]]
    JC = [[sum(J[r][k] * cov[k][j] for k in range(3)) for j in range(3)]
          for r in range(2)]
    a = sum(JC[0][k] * J[0][k] for k in range(3)) + COV2D_DILATE
    b = sum(JC[0][k] * J[1][k] for k in range(3))
    c = sum(JC[1][k] * J[1][k] for k in range(3)) + COV2D_DILATE
    det = a * c - b * b
    valid = valid & (det > 0.0)
    inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    tau = 2.0 * (torch.log(torch.clamp(opacity, min=1e-12))
                 - math.log(ALPHA_MIN))
    valid = valid & (tau > 0.0)
    tau = torch.clamp(tau, min=0.0)
    zero = torch.zeros_like(tau)
    rx = torch.where(valid, torch.ceil(torch.sqrt(tau * a.clamp(min=0))), zero)
    ry = torch.where(valid, torch.ceil(torch.sqrt(tau * c.clamp(min=0))), zero)
    center = 0.5 * (size - 1)
    mean2d = torch.stack([focal * tx * inv_z + center,
                          focal * ty * inv_z + center], dim=-1)
    return {"mean2d": mean2d, "conic": conic, "depth": tz, "valid": valid,
            "rx": rx, "ry": ry, "opacity": opacity, "color": g[:, 11:14]}


@torch.no_grad()
def bin_tiles(p: dict, size: int, tile_h: int, tile_w: int, dup: int,
              mpt: int):
    """Tile binning: each active splat's first ``dup`` live tiles of its
    extent (pairs the conic provably keeps under the alpha cut dropped),
    entries grouped per tile nearest first, ``mpt`` kept a tile. Returns
    (slot -> depth rank [T * mpt], N for a dead slot; counts [T]; order
    [N], the Gaussian of each depth rank)."""
    N = p["depth"].shape[0]
    tiles_y, tiles_x = size // tile_h, size // tile_w
    T = tiles_y * tiles_x
    dev = p["depth"].device
    active = p["valid"] & (torch.maximum(p["rx"], p["ry"]) > 0)
    order = torch.argsort(torch.where(active, p["depth"],
                                      torch.full_like(p["depth"], math.inf)),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=dev)

    def span(cen, r, tile, tiles):
        lo = torch.clamp(torch.floor((cen - r) / tile), 0, tiles).long()
        hi = torch.clamp(torch.floor((cen + r) / tile) + 1, 0, tiles).long()
        return lo, hi

    x0, x1 = span(p["mean2d"][:, 0], p["rx"], tile_w, tiles_x)
    y0, y1 = span(p["mean2d"][:, 1], p["ry"], tile_h, tiles_y)
    w, h = x1 - x0, y1 - y0
    d = torch.arange(2 * dup, device=dev)
    wi = torch.clamp(w, min=1)[:, None]
    tx = x0[:, None] + d[None, :] % wi
    ty = y0[:, None] + d[None, :] // wi
    ok = active[:, None] & (d[None, :] < (w * h)[:, None])
    A, B, C = (p["conic"][:, i:i + 1] for i in range(3))
    rx0 = tx.to(A.dtype) * tile_w - p["mean2d"][:, 0:1]
    rx1 = rx0 + (tile_w - 1)
    ry0 = ty.to(A.dtype) * tile_h - p["mean2d"][:, 1:2]
    ry1 = ry0 + (tile_h - 1)
    A_s, C_s = A.clamp(min=1e-8), C.clamp(min=1e-8)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def edge_x(e):
        dy = clip(-B * e / C_s, ry0, ry1)
        return A * e * e + 2.0 * B * e * dy + C * dy * dy

    def edge_y(e):
        dx = clip(-B * e / A_s, rx0, rx1)
        return A * dx * dx + 2.0 * B * dx * e + C * e * e

    qmin = torch.minimum(torch.minimum(edge_x(rx0), edge_x(rx1)),
                         torch.minimum(edge_y(ry0), edge_y(ry1)))
    inside = (rx0 <= 0) & (0 <= rx1) & (ry0 <= 0) & (0 <= ry1)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    tau = 2.0 * (torch.log(torch.clamp(p["opacity"][:, None], min=1e-12))
                 - math.log(ALPHA_MIN))
    ok = ok & (qmin <= tau)
    tile_id = ty * tiles_x + tx
    invalid = T * N
    key = torch.where(ok, tile_id * N + rank[:, None],
                      torch.full_like(tile_id, invalid))
    key = torch.sort(key, dim=1).values[:, :dup].reshape(-1)
    skeys = torch.sort(key).values
    bounds = torch.searchsorted(skeys, torch.arange(T + 1, device=dev) * N)
    starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - starts, max=mpt)
    pad = torch.full((mpt,), invalid, dtype=skeys.dtype, device=dev)
    pos = torch.arange(mpt, device=dev)
    keys_t = torch.cat([skeys, pad])[starts[:, None] + pos[None, :]]
    live = pos[None, :] < counts[:, None]
    slot_rank = torch.where(
        live, keys_t - (torch.arange(T, device=dev) * N)[:, None],
        torch.full_like(keys_t, N)).reshape(-1)
    return slot_rank, counts, order


def composite(rows: torch.Tensor, counts: torch.Tensor, size: int,
              tile_h: int, tile_w: int):
    """Front-to-back composite of slot rows [T, MPT, 9] (x̄, ȳ, A, B, C,
    op, r, g, b) per tile. Returns (rgb [T, 3, P], alpha [T, 1, P],
    final transmittance [T, 1, P])."""
    T, MPT, _ = rows.shape
    P = tile_h * tile_w
    dev = rows.device
    pix = torch.arange(P, device=dev)
    lx = (pix % tile_w).to(rows.dtype)
    ly = (pix // tile_w).to(rows.dtype)
    tid = torch.arange(T, device=dev)
    tiles_x = size // tile_w
    ox = ((tid % tiles_x) * tile_w).to(rows.dtype)[:, None, None]
    oy = ((tid // tiles_x) * tile_h).to(rows.dtype)[:, None, None]
    Tr = torch.ones(T, 1, P, dtype=rows.dtype, device=dev)
    rgb = torch.zeros(T, 3, P, dtype=rows.dtype, device=dev)
    acc = torch.zeros(T, 1, P, dtype=rows.dtype, device=dev)
    for c0 in range(0, MPT, CHUNK):
        with torch.no_grad():
            live = (c0 < counts) & (Tr.amax(dim=(1, 2)) > T_EPS)
            if not bool(live.any()):
                break
        blk = rows[:, c0:c0 + CHUNK]
        dx = lx - (blk[..., 0:1] - ox)
        dy = ly - (blk[..., 1:2] - oy)
        power = (-0.5 * (blk[..., 2:3] * dx * dx + blk[..., 4:5] * dy * dy)
                 - blk[..., 3:4] * dx * dy)
        araw = blk[..., 5:6] * torch.exp(power)
        use = live[:, None, None] & (power <= 0.0) & (araw >= ALPHA_MIN)
        alpha = torch.where(use, torch.clamp(araw, max=ALPHA_MAX),
                            torch.zeros_like(araw))
        cp = torch.cumprod(1.0 - alpha, dim=1)
        w = alpha * torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]],
                              dim=1) * Tr
        rgb = rgb + torch.einsum("tgc,tgp->tcp", blk[..., 6:9], w)
        acc = acc + w.sum(dim=1, keepdim=True)
        Tr = Tr * cp[:, -1:]
    return rgb, acc, Tr


def render_view(g: torch.Tensor, view: torch.Tensor, size: int, tan: float,
                bg: torch.Tensor, dup: int, tile_h: int = 32,
                tile_w: int = 32, max_per_tile: int = 1024,
                dtype: torch.dtype = torch.float32):
    """One view of Gaussians [N, 14]: image [S, S, 3] clamped to [0, 1]
    over ``bg`` [3], and alpha [S, S], computed in ``dtype`` (f32; bf16
    for a control) and returned in f32. Differentiable in ``g``. A tile
    keeps ``max_per_tile`` entries rounded down to whole chunks (at least
    one)."""
    mpt = max(CHUNK, max_per_tile // CHUNK * CHUNK)
    g, view, bg = g.to(dtype), view.to(dtype), bg.to(dtype)
    p = project(g, view, size, tan)
    slot_rank, counts, order = bin_tiles(p, size, tile_h, tile_w, dup, mpt)
    attrs = torch.cat([p["mean2d"], p["conic"], p["opacity"][:, None],
                       p["color"]], dim=1)[order]
    attrs = torch.cat([attrs, torch.zeros_like(attrs[:1])], dim=0)
    tiles_y, tiles_x = size // tile_h, size // tile_w
    rows = attrs[slot_rank].reshape(tiles_y * tiles_x, mpt, 9)
    rgb, acc, Tr = composite(rows, counts, size, tile_h, tile_w)

    def unpack(x):
        k = x.shape[1]
        return x.reshape(tiles_y, tiles_x, k, tile_h, tile_w).permute(
            0, 3, 1, 4, 2).reshape(size, size, k)

    image = unpack(rgb) + unpack(Tr) * bg
    return (torch.clamp(image, 0.0, 1.0).float(),
            unpack(acc)[..., 0].float())


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """x255 then truncation toward zero, as the orbit video stores frames."""
    return (image * 255.0).to(torch.uint8)
