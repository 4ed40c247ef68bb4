"""Image resizing with OpenCV's interpolation rules, in numpy.

``lgm_tpu`` resizes through ``cv2.resize`` in three places with three
interpolations (``utils/image.py::recenter``: ``INTER_AREA``;
``diffusion/pipeline.py::encode_image``: ``INTER_CUBIC``;
``encode_image_latents`` and ``infer.py``'s view resize:
``INTER_LINEAR``). The port does not rely on ``cv2`` (a host may lack it,
or have a version other than the 5.0 that ``lgm_tpu`` is held to), so it
keeps its own counterpart of each: one weight matrix an axis, applied as
``Wy @ img @ Wxᵀ`` (host code, off the device path). The weights follow
OpenCV's ``resize.cpp`` for float images:

- ``linear``: source coordinate ``(d + 0.5) * scale - 0.5``, two taps,
  indices clamped to the edge;
- ``cubic``: the same coordinate, four taps with Keys' kernel at
  A = -0.75, indices clamped to the edge (BORDER_REPLICATE);
- ``area`` when neither axis grows: each output pixel averages the source
  cells it covers, fractional cells weighted by the area covered
  (``computeResizeAreaTab``; not ``adaptive_avg_pool2d``, which takes
  whole cells); when an axis grows, OpenCV's ``INTER_AREA`` is a linear
  interpolation on both axes with source cell ``floor(d * scale)`` and
  weight ``frac((d + 1) - (s + 1) / scale)``.

``scale`` is source size over destination size, per axis.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_CUBIC_A = -0.75


def _cubic_coeffs(x: float):
    a = _CUBIC_A
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return (c0, c1, c2, 1.0 - c0 - c1 - c2)


def _float32(x: float) -> float:
    """OpenCV computes the source coordinate in float64 and keeps each
    weight in float32."""
    return float(np.float32(x))


def _interp_weights(src: int, dst: int, mode: str) -> np.ndarray:
    """[dst, src] weights of one axis for ``linear``, ``cubic`` or the
    enlarging form of ``area``."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        if mode == "area":
            s = math.floor(d * scale)
            f = _float32((d + 1) - (s + 1) / scale)
            f = 0.0 if f <= 0 else f - math.floor(f)
        else:
            f = (d + 0.5) * scale - 0.5
            s = math.floor(f)
            f -= s
        if mode == "cubic":
            taps = zip(range(s - 1, s + 3), _cubic_coeffs(f))
        else:
            taps = ((s, 1.0 - f), (s + 1, f))
        for idx, c in taps:
            w[d, min(max(idx, 0), src - 1)] += _float32(c)
    return w


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] fractional-area weights of one shrinking axis."""
    scale = src / dst
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += _float32((s1 - f1) / cell)
        for s in range(s1, s2):
            w[d, s] += _float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] += _float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def resize(img: np.ndarray, size: Tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=...)`` for a float image
    [H, W] or [H, W, C]: ``interpolation`` is ``"linear"``, ``"cubic"`` or
    ``"area"``. Returns float32 [h, w(, C)]."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if out_w <= 0 or out_h <= 0 or h == 0 or w == 0:
        raise ValueError(f"resize: cannot resize {img.shape[:2]} to "
                         f"{(out_h, out_w)}")
    if interpolation not in ("linear", "cubic", "area"):
        raise ValueError(f"resize: unknown interpolation {interpolation!r}")
    if interpolation == "area" and h >= out_h and w >= out_w:
        wy, wx = _area_weights(h, out_h), _area_weights(w, out_w)
    else:
        wy = _interp_weights(h, out_h, interpolation)
        wx = _interp_weights(w, out_w, interpolation)
    src = np.asarray(img, np.float64)
    out = np.tensordot(wy, src, axes=(1, 0))           # [oh, w, ...]
    out = np.tensordot(wx, out, axes=(1, 1))           # [ow, oh, ...]
    return np.ascontiguousarray(np.swapaxes(out, 0, 1)).astype(np.float32)
