"""Triangle rasterization in plain PyTorch (nvdiffrast equivalent).

Port of ``lgm_tpu/ops/trirast.py``, used by the converter's mesh-fitting
stages (ref: convert.py:82-85,239-254,382-384). Same split as nvdiffrast:

1. ``rasterize``: hard visibility, per pixel the nearest covering face id.
   No gradient. Tile-binned: faces are binned to 32² screen tiles by their
   bounding boxes, and each tile takes **the first ``max_faces_per_tile``
   covering faces in face-index order** (``jnp.nonzero(m, size=K)``, as
   lgm_tpu does; the faces past the cap are dropped), then z-resolves
   them with dense [pixels x faces] edge tests.
2. ``interpolate``: differentiable perspective-correct barycentric
   interpolation of vertex attributes at the rasterized faces.
3. ``texture``: differentiable bilinear texture sampling.

Clip-space convention matches the renderer: clip = [x, y, z, w] with
pixel = ((x/w) * 0.5 + 0.5) * S - 0.5 and w > 0 in front of the camera.
"""

from __future__ import annotations

import torch


def project_vertices(verts: torch.Tensor, view_proj: torch.Tensor):
    """verts [V, 3] x transposed view-proj [4, 4] (reference layout,
    row-vector convention) -> clip [V, 4]."""
    homo = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=1)
    return homo @ view_proj


def _screen(clip: torch.Tensor, S: int):
    w = clip[:, 3:4]
    w_safe = torch.where(torch.abs(w) < 1e-8, 1e-8, w)
    ndc = clip[:, :3] / w_safe
    px = (ndc[:, 0] * 0.5 + 0.5) * S - 0.5
    py = (ndc[:, 1] * 0.5 + 0.5) * S - 0.5
    return w, w_safe, ndc, px, py


def bin_faces(clip: torch.Tensor, faces: torch.Tensor, image_size: int,
              tile: int = 32, max_faces_per_tile: int = 1024):
    """Per tile, the faces whose screen bounding box covers it (all three
    vertices in front of the camera). Returns (idx [T, K] int64: the first
    K = ``max_faces_per_tile`` such faces in face-index order, padded with
    F; count [T]: how many faces cover each tile before the cap)."""
    S = image_size
    nt = S // tile
    F = faces.shape[0]
    K = max_faces_per_tile
    w, _, _, px, py = _screen(clip, S)
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    x0, y0, x1, y1, x2, y2 = px[v0], py[v0], px[v1], py[v1], px[v2], py[v2]
    valid = (w[v0, 0] > 1e-6) & (w[v1, 0] > 1e-6) & (w[v2, 0] > 1e-6)

    def span(lo, hi):
        a = torch.clamp(torch.floor(lo / tile), 0, nt).to(torch.int64)
        b = torch.clamp(torch.floor(hi / tile) + 1, 0, nt).to(torch.int64)
        return a, b

    fx0, fx1 = span(torch.minimum(torch.minimum(x0, x1), x2),
                    torch.maximum(torch.maximum(x0, x1), x2))
    fy0, fy1 = span(torch.minimum(torch.minimum(y0, y1), y2),
                    torch.maximum(torch.maximum(y0, y1), y2))
    tids = torch.arange(nt * nt, device=clip.device)
    tx = (tids % nt)[:, None]
    ty = (tids // nt)[:, None]
    m = (valid[None] & (fx0[None] <= tx) & (tx < fx1[None])
         & (fy0[None] <= ty) & (ty < fy1[None]))                  # [T, F]
    # Rank of each covering face within its tile, in face-index order.
    rank = torch.cumsum(m, dim=1) - 1
    keep = m & (rank < K)
    idx = torch.full((nt * nt, K), F, dtype=torch.int64, device=clip.device)
    t_i, f_i = keep.nonzero(as_tuple=True)
    idx[t_i, rank[t_i, f_i]] = f_i
    return idx, m.sum(1)


def rasterize(
    clip: torch.Tensor,
    faces: torch.Tensor,
    image_size: int,
    tile: int = 32,
    max_faces_per_tile: int = 1024,
    tile_chunk: int = 16,
):
    """Hard rasterization, without gradient.

    Args:
      clip: [V, 4] clip-space vertices.
      faces: [F, 3] integer.
      tile_chunk: tiles resolved together ([chunk, pixels, K] temporaries).
    Returns dict(face_id [S, S] int64 (-1 = background),
                 bary [S, S, 3] screen-space barycentrics,
                 tile_faces [T]: covering faces a tile before the cap).
    """
    S = image_size
    assert S % tile == 0
    nt = S // tile
    F = faces.shape[0]
    dev = clip.device
    with torch.no_grad():
        clip = clip.detach()
        idx, tile_faces = bin_faces(clip, faces, S, tile,
                                    max_faces_per_tile)
        _, _, ndc, px, py = _screen(clip, S)
        pz = ndc[:, 2]
        v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]

        # Padded face entry -> degenerate (never covers, infinite depth).
        def pad1(a, val):
            return torch.cat([a, a.new_full((1,), val)])

        fx = torch.stack([pad1(px[v0], 0.0), pad1(px[v1], 0.0),
                          pad1(px[v2], 0.0)], -1)[idx]
        fy = torch.stack([pad1(py[v0], 0.0), pad1(py[v1], 0.0),
                          pad1(py[v2], 0.0)], -1)[idx]
        fz = torch.stack([pad1(pz[v0], torch.inf), pad1(pz[v1], torch.inf),
                          pad1(pz[v2], torch.inf)], -1)[idx]  # [T, K, 3]

        ys = torch.arange(tile, dtype=torch.float32, device=dev)
        gy, gx = torch.meshgrid(ys, ys, indexing="ij")
        P = tile * tile
        tids = torch.arange(nt * nt, device=dev)
        local, bary = [], []
        for c in range(0, nt * nt, tile_chunk):
            t_idx = tids[c:c + tile_chunk]
            tfx, tfy, tfz = (a[c:c + tile_chunk] for a in (fx, fy, fz))
            tx = ((t_idx % nt).to(torch.float32) * tile)[:, None, None]
            ty = ((t_idx // nt).to(torch.float32) * tile)[:, None, None]
            pxs = (gx + tx).reshape(-1, P, 1)  # [C, P, 1]
            pys = (gy + ty).reshape(-1, P, 1)
            ax, bx, cx = (tfx[:, None, :, i] for i in range(3))
            ay, by, cy = (tfy[:, None, :, i] for i in range(3))
            # Edge functions.
            e0 = (bx - ax) * (pys - ay) - (by - ay) * (pxs - ax)
            e1 = (cx - bx) * (pys - by) - (cy - by) * (pxs - bx)
            e2 = (ax - cx) * (pys - cy) - (ay - cy) * (pxs - cx)
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            inside = (
                ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (area > 1e-12))
                | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0) & (area < -1e-12))
            )  # [C, P, K]: both windings rasterized
            area_safe = torch.where(torch.abs(area) < 1e-12, 1.0, area)
            b0 = e1 / area_safe
            b1 = e2 / area_safe
            b2 = e0 / area_safe
            z = (b0 * tfz[:, None, :, 0] + b1 * tfz[:, None, :, 1]
                 + b2 * tfz[:, None, :, 2])
            z = torch.where(inside, z, torch.inf)
            zmin, best = torch.min(z, dim=2)   # the first minimum
            hit = torch.isfinite(zmin)
            bb = torch.stack([torch.gather(b, 2, best[..., None])[..., 0]
                              for b in (b0, b1, b2)], dim=-1)
            local.append(torch.where(hit, best, -1))
            bary.append(torch.where(hit[..., None], bb, 0.0))
        local = torch.cat(local)                     # [T, P]
        bary = torch.cat(bary)                       # [T, P, 3]
        # Local candidate index -> global face id.
        face_id = torch.where(
            local >= 0,
            torch.gather(idx, 1, torch.clamp_min(local, 0)), -1)
        face_id = torch.where(face_id >= F, -1, face_id)

        def detile(a):
            shp = (nt, nt, tile, tile) + a.shape[2:]
            return a.reshape(shp).permute(
                (0, 2, 1, 3) + tuple(range(4, a.ndim + 2))
            ).reshape((S, S) + a.shape[2:])

        return {"face_id": detile(face_id), "bary": detile(bary),
                "tile_faces": tile_faces}


def interpolate(
    attrs: torch.Tensor,
    faces: torch.Tensor,
    face_id: torch.Tensor,
    verts: torch.Tensor,
    view_proj: torch.Tensor,
    image_size: int,
):
    """Differentiable perspective-correct attribute interpolation.

    Recomputes barycentrics analytically from the (fixed) face ids so
    gradients flow into ``verts`` and ``attrs`` (nvdiffrast's
    rasterize-then-interpolate contract).

    attrs [V, C] -> out [S, S, C]; background pixels get zeros.
    Also returns the hit mask [S, S].
    """
    S = image_size
    clip = project_vertices(verts, view_proj)
    _, w_safe, _, px, py = _screen(clip, S)

    fid = torch.clamp_min(face_id, 0)
    tri = faces[fid]  # [S, S, 3]
    t0, t1, t2 = tri[..., 0], tri[..., 1], tri[..., 2]
    ax, ay, aw = px[t0], py[t0], w_safe[t0, 0]
    bx, by, bw = px[t1], py[t1], w_safe[t1, 0]
    cx, cy, cw = px[t2], py[t2], w_safe[t2, 0]

    ys = torch.arange(S, dtype=torch.float32, device=verts.device)
    gy, gx = torch.meshgrid(ys, ys, indexing="ij")

    e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax)
    e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx)
    e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    area = torch.where(torch.abs(area) < 1e-12, 1e-12, area)
    b0, b1, b2 = e1 / area, e2 / area, e0 / area

    # Perspective correction: weight screen barycentrics by 1/w.
    q0, q1, q2 = b0 / aw, b1 / bw, b2 / cw
    qs = q0 + q1 + q2
    qs = torch.where(torch.abs(qs) < 1e-12, 1e-12, qs)
    p0, p1, p2 = q0 / qs, q1 / qs, q2 / qs

    out = (p0[..., None] * attrs[t0] + p1[..., None] * attrs[t1]
           + p2[..., None] * attrs[t2])
    mask = face_id >= 0
    return torch.where(mask[..., None], out, 0.0), mask


def texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Differentiable bilinear sampling: tex [H, W, C], uv [..., 2] in
    [0, 1] -> [..., C] (clamped addressing)."""
    H, W = tex.shape[:2]
    x = torch.clamp(uv[..., 0] * W - 0.5, 0.0, W - 1.0)
    y = torch.clamp(uv[..., 1] * H - 0.5, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    t00 = tex[y0, x0]
    t01 = tex[y0, x0 + 1]
    t10 = tex[y0 + 1, x0]
    t11 = tex[y0 + 1, x0 + 1]
    return (
        t00 * (1 - wx) * (1 - wy) + t01 * wx * (1 - wy)
        + t10 * (1 - wx) * wy + t11 * wx * wy
    )


def render_mesh(
    verts: torch.Tensor,
    faces: torch.Tensor,
    attrs: torch.Tensor,
    view_proj: torch.Tensor,
    image_size: int,
    max_faces_per_tile: int = 1024,
):
    """rasterize (detached vertices) + interpolate in one call. Returns
    (out [S, S, C], mask [S, S])."""
    clip = project_vertices(verts.detach(), view_proj)
    rast = rasterize(clip, faces, image_size,
                     max_faces_per_tile=max_faces_per_tile)
    return interpolate(attrs, faces, rast["face_id"], verts, view_proj,
                       image_size)
