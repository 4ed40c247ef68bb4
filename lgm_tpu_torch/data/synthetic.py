"""Synthetic multi-view dataset: procedural Gaussian scenes rendered by the
port's own rasterizer.

Port of ``lgm_tpu/data/synthetic.py``. It samples random blobby Gaussian
objects and orbit poses on the host from numpy's ``default_rng((seed,
step))`` (the same stream as lgm_tpu's, so scenes, poses and cameras agree
bit for bit), then renders the ground-truth and input views on the device
through ``render_views`` (flatsort: kernel K2 on the card) without
gradient, and emits the provider data contract (NHWC):

  input          [B, V_in, H, W, 9]  ImageNet-normalized RGB + Plücker rays
  images_output  [B, V, S, S, 3]     white-bg composited RGB
  masks_output   [B, V, S, S, 1]
  cam_view / cam_view_proj / cam_pos
  scenes         [B, N, 14] host numpy (for oracles and debugging)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lgm_tpu_torch.config import Options
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.utils import camera

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


def sample_poses(rng: np.random.Generator, opt: Options) -> np.ndarray:
    """V orbit poses: V_in evenly spaced input views at a random elevation,
    then random supervision views; pose 0 canonicalized to the fixed front
    position (ref: core/provider_objaverse.py:127-128)."""
    el_in = rng.uniform(-20.0, 20.0)
    az0 = rng.uniform(0.0, 360.0)
    poses = [
        camera.orbit_camera(
            el_in, az0 + i * (360.0 / opt.num_input_views), opt.cam_radius
        )
        for i in range(opt.num_input_views)
    ]
    for _ in range(opt.num_views - opt.num_input_views):
        poses.append(
            camera.orbit_camera(
                rng.uniform(-60.0, 60.0), rng.uniform(0, 360),
                opt.cam_radius,
            )
        )
    return camera.canonicalize_poses(np.stack(poses), opt.cam_radius)


def make_batch(rng: np.random.Generator, opt: Options,
               batch_size: Optional[int] = None, n_gaussians: int = 512,
               device="cuda") -> Dict[str, object]:
    """One batch: the image-sized tensors rendered on ``device``, the
    cameras as f32 tensors there, the scenes as host numpy."""
    B = batch_size or opt.batch_size
    dev = torch.device(device)
    scenes = np.stack([sample_scene(rng, n_gaussians) for _ in range(B)])
    poses = np.stack([sample_poses(rng, opt) for _ in range(B)])
    cams = camera.build_camera_inputs(poses, opt.fovy, opt.znear, opt.zfar)
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    Vi = opt.num_input_views

    g = torch.as_tensor(scenes, device=dev)
    cam_view = torch.as_tensor(cams["cam_view"], dtype=torch.float32,
                               device=dev)
    with torch.no_grad():
        out = render_views(g, cam_view, opt.output_size, tan,
                           with_depth=False)
        images_output = out["image"]
        masks_output = torch.clamp(out["alpha"], 0.0, 1.0)
        if opt.input_size == opt.output_size:
            images_in = images_output[:, :Vi]
        else:
            images_in = render_views(g, cam_view[:, :Vi], opt.input_size,
                                     tan, with_depth=False)["image"]
        mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
        std = torch.as_tensor(IMAGENET_STD, device=dev)
        plucker = np.stack([
            np.stack([camera.plucker_rays(p, opt.input_size, opt.input_size,
                                          opt.fovy) for p in row])
            for row in poses[:, :Vi]]).astype(np.float32)
        inputs = torch.cat([(images_in - mean) / std,
                            torch.as_tensor(plucker, device=dev)], dim=-1)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return {
        "input": inputs,
        "images_output": images_output,
        "masks_output": masks_output,
        "cam_view": cam_view,
        "cam_view_proj": f32(cams["cam_view_proj"]),
        "cam_pos": f32(cams["cam_pos"]),
        "scenes": scenes,
    }


class SyntheticDataset:
    """Synthetic batches, a fixed stream per (seed, step)."""

    def __init__(self, opt: Options, training: bool = True,
                 n_gaussians: int = 512, length: int = 1000, seed: int = 0,
                 device="cuda"):
        self.opt = opt
        self.training = training
        self.n_gaussians = n_gaussians
        self.length = length
        self.seed = seed if training else seed + 777_777
        self.device = device

    def __len__(self):
        return self.length

    def batch(self, step: int) -> Dict[str, object]:
        rng = np.random.default_rng((self.seed, step))
        return make_batch(rng, self.opt, n_gaussians=self.n_gaussians,
                          device=self.device)
