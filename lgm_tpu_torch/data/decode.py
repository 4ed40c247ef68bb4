"""Decode, composite and resize dataset views on the host.

Port of ``lgm_tpu/native.py::load_views`` (``native/dataload.cpp``),
which the card host cannot build (it links libpng and libjpeg). Each view
is read by ``io/image.py`` (PNG or JPEG by the magic bytes, as
``dataload.cpp::decode_file`` tells them apart), composited onto white
and resized bilinearly to up to two square sizes, with the float32
arithmetic of ``dataload.cpp::composite`` (``:141-156``) and ``resize_bilinear``
(``:160-204``): source coordinate ``(d + 0.5) * (src / dst) - 0.5`` in
float32 (not ``utils/resize.py``'s copy of cv2 5.0, which takes it in
float64), edges clamped, the four taps summed in the C++ order. Views
decode on a thread pool: ``zlib``, the C++ unfilter and JPEG decoder and
numpy release the GIL.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from lgm_tpu_torch.io import ImageError, image

_F32 = np.float32
_INV_255 = _F32(1.0) / _F32(255.0)


def composite(rgba: np.ndarray, has_alpha: bool
              ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 RGBA [H, W, 4] -> (white-background RGB [H, W, 3], mask
    [H, W]) in float32: ``c * a + (1 - a)``, mask ``a``; 1 without alpha."""
    c = rgba[..., :3].astype(_F32) * _INV_255
    if not has_alpha:
        return c, np.ones(rgba.shape[:2], _F32)
    a = rgba[..., 3].astype(_F32) * _INV_255
    return c * a[..., None] + (_F32(1.0) - a)[..., None], a


def _taps(n_src: int, n_dst: int):
    """Per output index: the two source indices and the weight of the
    second, as ``resize_bilinear`` takes them."""
    scale = _F32(n_src) / _F32(n_dst)
    f = (np.arange(n_dst, dtype=_F32) + _F32(0.5)) * scale - _F32(0.5)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(_F32)
    low = i0 < 0
    i0[low], f[low] = 0, 0
    i1 = np.minimum(i0 + 1, n_src - 1)
    high = i0 > n_src - 1
    i0[high], f[high] = n_src - 1, 0
    return i0, i1, f


def resize_bilinear(src: np.ndarray, size: int) -> np.ndarray:
    """float32 [H, W, C] -> [size, size, C]; a copy at the same size."""
    h, w = src.shape[:2]
    if h == size and w == size:
        return src.copy()
    y0, y1, fy = _taps(h, size)
    x0, x1, fx = _taps(w, size)
    fy, fx = fy[:, None, None], fx[None, :, None]
    gy, gx = _F32(1.0) - fy, _F32(1.0) - fx
    r0, r1 = src[y0], src[y1]
    return (((gy * gx) * r0[:, x0] + (gy * fx) * r0[:, x1])
            + (fy * gx) * r1[:, x0]) + (fy * fx) * r1[:, x1]


def _load_one(path: str, size_a: int, size_b: int):
    try:
        rgba, has_alpha = image.read_rgba(path)
    except ImageError:
        return None
    rgb, mask = composite(rgba, has_alpha)
    out = []
    for s in (size_a, size_b) if size_b > 0 else (size_a,):
        out += [resize_bilinear(rgb, s), resize_bilinear(mask[..., None],
                                                         s)[..., 0]]
    return out


def load_views(paths: List[str], size_a: int, size_b: int = 0,
               n_threads: int = 4):
    """Decode ``len(paths)`` PNGs or JPEGs; white-background composite;
    bilinear resize to ``size_a`` (and ``size_b`` when > 0). Returns
    (rgb_a [n, Sa, Sa, 3], mask_a [n, Sa, Sa], rgb_b | None, mask_b |
    None, ok [n] bool).
    Unreadable entries have ``ok`` False and zero pixels (callers skip and
    pad, the provider contract)."""
    n = len(paths)
    rgb_a = np.zeros((n, size_a, size_a, 3), _F32)
    mask_a = np.zeros((n, size_a, size_a), _F32)
    rgb_b: Optional[np.ndarray] = None
    mask_b: Optional[np.ndarray] = None
    if size_b > 0:
        rgb_b = np.zeros((n, size_b, size_b, 3), _F32)
        mask_b = np.zeros((n, size_b, size_b), _F32)
    ok = np.zeros(n, bool)
    with ThreadPoolExecutor(max(1, min(n_threads, n))) as pool:
        results = list(pool.map(lambda p: _load_one(p, size_a, size_b),
                                paths))
    for i, res in enumerate(results):
        if res is None:
            continue
        ok[i] = True
        rgb_a[i], mask_a[i] = res[0], res[1]
        if size_b > 0:
            rgb_b[i], mask_b[i] = res[2], res[3]
    return rgb_a, mask_a, rgb_b, mask_b, ok
