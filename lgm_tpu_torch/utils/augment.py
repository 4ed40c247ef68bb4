"""Training augmentations (host-side numpy).

The package's own copy of ``lgm_tpu/utils/augment.py`` (ref:
core/utils.py:45-108): ``grid_distortion``, a piecewise-linear random warp
simulating multi-view 3D inconsistency, and ``orbit_camera_jitter``, a
random orbital rotation of poses through Rodrigues' formula. They stay
numpy and draw from the caller's ``np.random.Generator`` in lgm_tpu's
order, so a seeded generator gives the same augmentation bit for bit.
They run in the data pipeline on the host, per sample.
"""

from __future__ import annotations

import numpy as np


def rotvec_to_rotmat(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues formula, [..., 3] -> [..., 3, 3]."""
    theta = np.linalg.norm(rotvec, axis=-1, keepdims=True)
    axis = rotvec / np.maximum(theta, 1e-12)
    k = axis
    K = np.zeros(rotvec.shape[:-1] + (3, 3), np.float32)
    K[..., 0, 1] = -k[..., 2]
    K[..., 0, 2] = k[..., 1]
    K[..., 1, 0] = k[..., 2]
    K[..., 1, 2] = -k[..., 0]
    K[..., 2, 0] = -k[..., 1]
    K[..., 2, 1] = k[..., 0]
    th = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), K.shape)
    return eye + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def orbit_camera_jitter(poses: np.ndarray, strength: float = 0.1,
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """Randomly rotate orbit poses about the origin. poses: [B, 4, 4]
    OpenGL c2w. Rotation vectors are scaled camera up (y) and right (x)
    axes, matching the reference's distribution (core/utils.py:48-55)."""
    rng = rng or np.random.default_rng()
    B = poses.shape[0]
    r1 = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    r2 = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    rotvec_x = poses[:, :3, 1] * (strength * np.pi * r1)
    rotvec_y = poses[:, :3, 0] * (strength * np.pi / 2 * r2)
    rot = rotvec_to_rotmat(rotvec_x) @ rotvec_to_rotmat(rotvec_y)
    out = poses.copy()
    out[:, :3, :3] = rot @ poses[:, :3, :3]
    out[:, :3, 3:] = rot @ poses[:, :3, 3:]
    return out


def grid_distortion(images: np.ndarray, strength: float = 0.5,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Random piecewise-linear warp of [B, H, W, C] images (NHWC; the
    reference is NCHW). Per image: 8..16 grid lines per axis, each
    perturbed by up to strength/2 cells, linear resampling in between."""
    rng = rng or np.random.default_rng()
    B, H, W, C = images.shape
    num_steps = int(rng.integers(8, 17))
    grid_steps = np.linspace(-1, 1, num_steps, dtype=np.float32)
    out = np.empty_like(images)

    def axis_coords(size):
        steps = np.linspace(0, 1, num_steps, dtype=np.float32)
        steps = np.clip(
            steps
            + strength
            * (rng.uniform(0, 1, num_steps).astype(np.float32) - 0.5)
            / (num_steps - 1),
            0, 1,
        )
        steps = (steps * size).astype(np.int64)
        steps[0], steps[-1] = 0, size
        segs = [
            np.linspace(grid_steps[i], grid_steps[i + 1],
                        steps[i + 1] - steps[i], dtype=np.float32)
            for i in range(num_steps - 1)
        ]
        return np.concatenate(segs)

    for b in range(B):
        xs = axis_coords(W)
        ys = axis_coords(H)
        out[b] = _bilinear_sample_sep(images[b], xs, ys)
    return out


def _bilinear_sample_sep(img: np.ndarray, xs: np.ndarray,
                         ys: np.ndarray):
    """Bilinear sampling of [H, W, C] at the meshgrid of 1-D normalized
    coordinates ``xs``, ``ys`` in [-1, 1] (align_corners=False, zero
    padding), interpolating rows then columns: the kernel is separable and
    zero padding factors into per-axis valid masks (lgm_tpu holds this
    against its generic 2-D sampler)."""
    H, W = img.shape[:2]

    def taps(coords, size):
        t = (coords + 1) * size / 2 - 0.5
        i0 = np.floor(t).astype(np.int64)
        w1 = (t - i0).astype(np.float32)
        i1 = i0 + 1
        v0 = ((i0 >= 0) & (i0 < size)).astype(np.float32)
        v1 = ((i1 >= 0) & (i1 < size)).astype(np.float32)
        return (np.clip(i0, 0, size - 1), np.clip(i1, 0, size - 1),
                (1.0 - w1) * v0, w1 * v1)

    y0, y1, wy0, wy1 = taps(ys, H)
    x0, x1, wx0, wx1 = taps(xs, W)
    tmp = img[y0] * wy0[:, None, None] + img[y1] * wy1[:, None, None]
    return tmp[:, x0] * wx0[None, :, None] + tmp[:, x1] * wx1[None, :, None]
