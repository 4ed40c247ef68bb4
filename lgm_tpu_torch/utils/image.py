"""Host-side image preprocessing for the single-image path.

The package's own copy of ``lgm_tpu/utils/image.py`` (ref: infer.py:81-82,
app.py:95-112, via kiui.op.recenter with border_ratio 0.2), with
``utils.resize`` in place of ``cv2.resize(..., INTER_AREA)``: the card
host has no ``cv2``. Pure numpy, off the device path.
"""

from __future__ import annotations

import numpy as np

from lgm_tpu_torch.utils.resize import resize


def recenter(image: np.ndarray, mask: np.ndarray,
             border_ratio: float = 0.2) -> np.ndarray:
    """Recenter the masked foreground in a square canvas: crop to the
    mask's bounding box, scale its longer side to (1 - border_ratio) of
    the canvas, paste centred.

    image [H, W, C] (any dtype), mask [H, W] bool -> [S, S, C] with
    S = max(H, W), in ``image``'s dtype; background pixels are zero."""
    h, w = image.shape[:2]
    size = max(h, w)
    out = np.zeros((size, size) + image.shape[2:], dtype=image.dtype)

    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        out[:h, :w] = image
        return out

    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    bh, bw = y1 - y0, x1 - x0
    desired = max(int(size * (1.0 - border_ratio)), 1)
    scale = desired / max(bh, bw)
    nh, nw = max(int(bh * scale), 1), max(int(bw * scale), 1)
    oy, ox = (size - nh) // 2, (size - nw) // 2

    crop = image[y0:y1, x0:x1]
    resized = resize(crop.astype(np.float32), (nw, nh), "area")
    out[oy:oy + nh, ox:ox + nw] = resized.astype(image.dtype)
    return out


def rgba_to_rgb_white(image: np.ndarray) -> np.ndarray:
    """[H, W, 4] float RGBA in [0, 1] -> [H, W, 3] RGB over white."""
    return image[..., :3] * image[..., 3:4] + (1.0 - image[..., 3:4])


def mv_grid_2x2(mv: np.ndarray) -> np.ndarray:
    """4 views -> the reference's 2x2 preview grid [[1, 2], [3, 0]]
    (ref: app.py:109-112)."""
    return np.concatenate([
        np.concatenate([mv[1], mv[2]], axis=1),
        np.concatenate([mv[3], mv[0]], axis=1),
    ], axis=0)
