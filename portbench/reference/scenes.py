"""The benchmark's own traffic generator: seeded Gaussian objects and the
views, rays and cameras made from them.

``sample_scene`` and ``sample_poses`` are frozen copies of the synthetic
dataset's generators (blobby objects inside [-0.75, 0.75]^3; four input
views evenly round a random elevation and random supervision views, pose
0 canonicalised to the front). The images are rendered by the benchmark's
plain renderer (``render.py``), never by the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import camera
from portbench.reference.render import render_view

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
# The renderer's live-tile cap for supervision renders (the synthetic
# dataset's default).
GT_DUP = 16


def sample_scene(rng: np.random.Generator, n: int, n_blobs: int = 6):
    """A random blobby object [n, 14]."""
    centers = rng.uniform(-0.45, 0.45, (n_blobs, 3))
    blob_col = rng.uniform(0.05, 0.95, (n_blobs, 3))
    assign = rng.integers(0, n_blobs, n)
    g = np.zeros((n, 14), np.float32)
    g[:, 0:3] = np.clip(centers[assign] + rng.normal(0, 0.12, (n, 3)),
                        -0.75, 0.75)
    g[:, 3] = rng.uniform(0.5, 1.0, n)
    g[:, 4:7] = rng.uniform(0.02, 0.08, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = np.clip(blob_col[assign] + rng.normal(0, 0.1, (n, 3)),
                          0, 1)
    return g


def sample_poses(rng: np.random.Generator, cfg: dict):
    """V c2w poses: the input views evenly round a random elevation, then
    random supervision views; pose 0 moved to the front."""
    vi, radius = cfg["num_input_views"], cfg["cam_radius"]
    el, az0 = rng.uniform(-20.0, 20.0), rng.uniform(0.0, 360.0)
    poses = [camera.orbit_camera(el, az0 + i * 360.0 / vi, radius)
             for i in range(vi)]
    poses += [camera.orbit_camera(rng.uniform(-60.0, 60.0),
                                  rng.uniform(0, 360), radius)
              for _ in range(cfg["num_views"] - vi)]
    return camera.canonicalize_poses(np.stack(poses), radius)


def tan_half_fov(cfg: dict) -> float:
    return float(np.tan(0.5 * np.deg2rad(cfg["fovy"])))


def network_input(images: torch.Tensor, poses: np.ndarray, cfg: dict):
    """Views [V, S, S, 3] in [0, 1] and their c2w poses -> the network's
    input [V, S, S, 9]: ImageNet-normalised RGB and Plücker rays."""
    dev = images.device
    rays = np.stack([camera.plucker_rays(p, images.shape[1], cfg["fovy"])
                     for p in poses]).astype(np.float32)
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    return torch.cat([(images - mean) / std,
                      torch.as_tensor(rays, device=dev)], dim=-1)


@torch.no_grad()
def render_set(scene: torch.Tensor, views: torch.Tensor, size: int,
               tan: float):
    """Views [V, 4, 4] of one scene on white: images [V, S, S, 3] and
    alphas [V, S, S, 1] clamped to [0, 1]."""
    white = torch.ones(3, device=scene.device)
    out = [render_view(scene, v, size, tan, white, GT_DUP) for v in views]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]).clamp(0, 1)[..., None])


def train_batch(rng: np.random.Generator, cfg: dict, batch: int,
                n_gaussians: int, device):
    """One training batch in the program's data contract: ``input`` [B,
    V_in, 256, 256, 9], ``images_output`` [B, V, 512, 512, 3],
    ``masks_output`` [B, V, 512, 512, 1], ``cam_view`` [B, V, 4, 4]."""
    tan = tan_half_fov(cfg)
    vi = cfg["num_input_views"]
    inputs, images, masks, views = [], [], [], []
    for _ in range(batch):
        scene = torch.as_tensor(sample_scene(rng, n_gaussians), device=device)
        poses = sample_poses(rng, cfg)
        cv = torch.as_tensor(camera.cam_view(poses), device=device)
        img, alpha = render_set(scene, cv, cfg["output_size"], tan)
        small, _ = render_set(scene, cv[:vi], cfg["input_size"], tan)
        inputs.append(network_input(small, poses[:vi], cfg))
        images.append(img)
        masks.append(alpha)
        views.append(cv)
    return {"input": torch.stack(inputs), "images_output": torch.stack(images),
            "masks_output": torch.stack(masks), "cam_view": torch.stack(views)}


def object_views(rng: np.random.Generator, cfg: dict, n_gaussians: int,
                 device) -> np.ndarray:
    """The four canonical views (elevation 0, azimuth 0/90/180/270) of a
    seeded object at the input size on white: host float [4, S, S, 3] in
    [0, 1], as a user hands them to ``infer``."""
    scene = torch.as_tensor(sample_scene(rng, n_gaussians), device=device)
    poses = camera.orbit_views(cfg["num_input_views"], cfg["cam_radius"])
    cv = torch.as_tensor(camera.cam_view(poses), device=device)
    img, _ = render_set(scene, cv, cfg["input_size"], tan_half_fov(cfg))
    return img.cpu().numpy()
