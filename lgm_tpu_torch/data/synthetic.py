"""Synthetic scenes: the numpy part of ``lgm_tpu/data/synthetic.py``.

The JAX module imports JAX (it renders its batches on the device), so the
port keeps its own copy of the host-side pieces: the ImageNet
normalization constants and the seeded blobby-object sampler.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def sample_scene(rng: np.random.Generator, n_gaussians: int = 512,
                 n_blobs: int = 6) -> np.ndarray:
    """Random blobby object [n_gaussians, 14]: clustered Gaussians inside
    [-0.75, 0.75]^3 (pos | opacity | scale | unit quat | rgb)."""
    centers = rng.uniform(-0.45, 0.45, (n_blobs, 3))
    blob_col = rng.uniform(0.05, 0.95, (n_blobs, 3))
    assign = rng.integers(0, n_blobs, n_gaussians)
    g = np.zeros((n_gaussians, 14), np.float32)
    g[:, 0:3] = centers[assign] + rng.normal(0, 0.12, (n_gaussians, 3))
    g[:, 0:3] = np.clip(g[:, 0:3], -0.75, 0.75)
    g[:, 3] = rng.uniform(0.5, 1.0, n_gaussians)
    g[:, 4:7] = rng.uniform(0.02, 0.08, (n_gaussians, 3))
    q = rng.normal(0, 1, (n_gaussians, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = np.clip(
        blob_col[assign] + rng.normal(0, 0.1, (n_gaussians, 3)), 0, 1
    )
    return g
