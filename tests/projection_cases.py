"""Scenes that reach every branch of the EWA projection, for the tests of
the projection kernels and their plain versions (numpy only: the card's
tests import it without JAX).

``case(name, dtype)`` -> (gaussians [N, 14], view [4, 4], scale_modifier)
as numpy arrays of ``dtype``. The identity camera (view = I: w2c = I, so
the camera-space position is the splat's own) makes the frustum clamp's
limit exactly reachable: x / z = lim at x = lim, z = 1.
"""

import numpy as np

from lgm_tpu_torch.ops.gsplat.projection import FRUSTUM_CLAMP
from lgm_tpu_torch.utils import camera

FOVY = 49.1
TAN = float(np.tan(0.5 * np.deg2rad(FOVY)))
SIZE = 128

CASES = ("orbit", "behind", "clamps", "det", "faint", "unnormalised",
         "scale_modifier")


def scene(n: int, rng: np.random.Generator) -> np.ndarray:
    """Splats around the origin with unit quaternions (float64)."""
    g = np.zeros((n, 14))
    g[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    g[:, 3] = rng.uniform(0.2, 1.0, n)
    g[:, 4:7] = rng.uniform(0.02, 0.1, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = rng.uniform(0, 1, (n, 3))
    return g


def orbit_view(el: float = 10.0, az: float = 30.0) -> np.ndarray:
    pose = camera.orbit_camera(el, az, 1.5)
    return camera.build_camera_inputs(pose[None], FOVY, 0.5, 2.5)[
        "cam_view"][0].astype(np.float64)


def case(name: str, dtype=np.float32):
    rng = np.random.default_rng(CASES.index(name) + 11)
    g = scene(256, rng)
    view, mod = np.eye(4), 1.0
    # In front of the identity camera: z in [1, 3], x and y inside the view.
    g[:, 2] = rng.uniform(1.0, 3.0, len(g))
    if name == "orbit":
        view = orbit_view()
    elif name == "behind":
        # Behind the camera, between it and the near plane, on the plane.
        g[:96, 2] = rng.uniform(-1.0, 0.2, 96)
        g[96, 2] = 0.2
    elif name == "clamps":
        # x / z and y / z past both limits, then exactly on them.
        lim = dtype(FRUSTUM_CLAMP * TAN)
        z = g[:128, 2]
        g[:128, 0] = z * rng.choice([-1, 1], 128) * rng.uniform(1.05, 3, 128)
        g[:128, 1] = z * rng.choice([-1, 1], 128) * rng.uniform(1.05, 3, 128)
        g[128:130, 2] = 1.0
        g[128, 0:2] = lim, -lim
        g[129, 0:2] = -lim, lim
    elif name == "det":
        # Needles far larger than the view: rank-1 covariances whose
        # det = ac - b² rounds to zero or below in f32 and f64.
        g[:64, 4] = 6e6
        g[:64, 5:7] = 0.0
    elif name == "faint":
        # Opacity at and below ALPHA_MIN, zero, and below the log's floor.
        g[:96, 3] = rng.uniform(0.0, 1.0 / 255.0, 96)
        g[96, 3] = 1.0 / 255.0
        g[97, 3] = 0.0
        g[98, 3] = 1e-13
    elif name == "unnormalised":
        g[:, 7:11] *= rng.uniform(0.2, 3.0, (len(g), 1))
        view = orbit_view(-20.0, 200.0)
    elif name == "scale_modifier":
        mod = 0.7
        view = orbit_view(30.0, 120.0)
    return g.astype(dtype), view.astype(dtype), mod
