"""Multi-view frame datasets for the diffusion U-Net finetune.

Port of ``lgm_tpu/diffusion/data.py``: the training-frame contract that
``diffusion/train.py`` consumes, host numpy in ``lgm_tpu``'s layout:

  images  [B, F, S, S, 3]  white-background RGB in [0, 1]; F orbit frames
                           of a scene at one elevation, evenly spaced
                           azimuths
  camera  [B, F, 16]       flattened blender-coordinate c2w at radius 1,
                           the conditioning ``get_camera`` builds at
                           sampling time
  prompts list[str]        one text prompt per scene

Two sources:

- ``SyntheticMVData``: seeded blobby Gaussian scenes (``data/synthetic.py``'s
  ``sample_scene``, the same numpy stream as ``lgm_tpu``'s) rendered by the
  port's rasterizer on ``device`` (flatsort: kernel K2 on the card, one
  launch a view, B·F a batch);
- ``LVISMVData``: the LVIS disk layout (``NNN.png`` + ``NNN.npy``
  {elevation, azimuth, radius} a view), the F views nearest an evenly
  spaced azimuth ring, decoded by ``io/image.py`` (PNG or JPEG) and
  composited on white with the f32 arithmetic of ``lgm_tpu``'s native
  decoder, resized as ``cv2.INTER_AREA`` does (``utils/resize.py``)
  where the size differs.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from lgm_tpu_torch.data.decode import composite
from lgm_tpu_torch.data.synthetic import sample_scene
from lgm_tpu_torch.io import image
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.utils import camera
from lgm_tpu_torch.utils.resize import resize

# The package's own copy of ``lgm_tpu``'s prompt list.
_PROMPTS = (
    "a 3d rendering of an object",
    "a colorful 3d object on a white background",
    "an isometric view of a small object",
    "a render of a toy object",
)


def blender_condition(elevation: float, azimuth: float) -> np.ndarray:
    """[16] flattened conditioning pose: the radius-1 orbit c2w with the
    blender coordinate flip, as ``get_camera`` feeds the U-Net at sampling
    time."""
    pose = camera.orbit_camera(float(elevation), float(azimuth), radius=1.0)
    pose = pose.copy()
    pose[2] *= -1
    pose[[1, 2]] = pose[[2, 1]]
    return pose.flatten().astype(np.float32)


class SyntheticMVData:
    """Procedural multi-view frames: random blobby Gaussian scenes rendered
    at F evenly spaced azimuths (random start, random elevation in
    [-10, 30]), a fixed stream per (seed, step % length)."""

    def __init__(self, num_frames: int = 4, image_size: int = 256,
                 length: int = 1024, seed: int = 0, fovy: float = 49.1,
                 radius: float = 1.5, n_gaussians: int = 512,
                 device="cuda"):
        self.num_frames = num_frames
        self.image_size = image_size
        self.length = length
        self.seed = seed
        self.fovy = fovy
        self.radius = radius
        self.n_gaussians = n_gaussians
        self.device = torch.device(device)

    def __len__(self):
        return self.length

    def batch(self, step: int, batch_size: int) -> Dict:
        rng = np.random.default_rng((self.seed, step % self.length))
        F = self.num_frames
        scenes, poses, cams16, prompts = [], [], [], []
        for _ in range(batch_size):
            g = sample_scene(rng, self.n_gaussians)
            el = float(rng.uniform(-10.0, 30.0))
            az0 = float(rng.uniform(0.0, 360.0))
            azs = az0 + np.arange(F) * (360.0 / F)
            poses.append(np.stack([
                camera.orbit_camera(el, float(a), self.radius) for a in azs
            ]))
            cams16.append(np.stack([
                blender_condition(el, float(a)) for a in azs
            ]))
            scenes.append(g)
            prompts.append(_PROMPTS[int(rng.integers(len(_PROMPTS)))])
        cam_in = camera.build_camera_inputs(np.stack(poses), self.fovy, 0.5,
                                            2.5)
        tan = float(np.tan(0.5 * np.deg2rad(self.fovy)))
        dev = self.device
        with torch.no_grad():
            out = render_views(
                torch.as_tensor(np.stack(scenes), device=dev),
                torch.as_tensor(cam_in["cam_view"], dtype=torch.float32,
                                device=dev),
                self.image_size, tan, with_depth=False)
        return {
            "images": out["image"].float().cpu().numpy(),
            "camera": np.stack(cams16).astype(np.float32),
            "prompts": prompts,
        }


class LVISMVData:
    """LVIS disk scenes -> diffusion frames (the file layout of
    ``data/provider.py``'s ``LVISDataset``; split ``40000-49999`` is left
    out)."""

    TEST_SPLITS = ("40000-49999",)

    def __init__(self, root: str, num_frames: int = 4,
                 image_size: int = 256, training: bool = True,
                 scene_dirs: Optional[List[str]] = None, seed: int = 0):
        self.num_frames = num_frames
        self.image_size = image_size
        self.training = training
        self.seed = seed
        if scene_dirs is None:
            splits = [
                s for s in sorted(os.listdir(root))
                if s not in self.TEST_SPLITS
                and os.path.isdir(os.path.join(root, s))
            ]
            scene_dirs = []
            for s in splits:
                scene_dirs.extend(sorted(
                    p for p in glob.glob(os.path.join(root, s, "*"))
                    if os.path.isdir(p)
                ))
        self.items = scene_dirs

    def __len__(self):
        return len(self.items)

    @staticmethod
    def _read_composited(path: str) -> np.ndarray:
        """White-background RGB [H, W, 3] in f32: ``rgb * a + (1 - a)``
        from the 8-bit values over 255 (``lgm_tpu``'s native decode and
        composite); raises ``ImageError`` for an unreadable file."""
        return composite(*image.read_rgba(path))[0]

    def _load_scene(self, uid: str, rng: np.random.Generator):
        views = []
        for cpath in sorted(glob.glob(os.path.join(uid, "*.npy"))):
            try:
                cam = np.load(cpath, allow_pickle=True).item()
            except Exception:
                continue
            views.append((os.path.splitext(cpath)[0] + ".png",
                          float(cam["elevation"]), float(cam["azimuth"])))
        if len(views) < self.num_frames:
            raise RuntimeError(f"too few views in {uid}")
        F = self.num_frames
        az0 = float(rng.uniform(0.0, 360.0)) if self.training else 0.0
        azs = np.asarray([v[2] for v in views])
        imgs, cams16 = [], []
        for k in range(F):
            want = (az0 + k * 360.0 / F) % 360.0
            d = np.abs((azs - want + 180.0) % 360.0 - 180.0)
            ipath, el, az = views[int(np.argmin(d))]
            rgb = self._read_composited(ipath)
            if rgb.shape[0] != self.image_size:
                rgb = resize(rgb, (self.image_size, self.image_size), "area")
            imgs.append(rgb)
            # The stored elevation is negated, as the rendering provider
            # reads it, so conditioning and geometry agree.
            cams16.append(blender_condition(-el, az))
        prompt = os.path.basename(uid).replace("_", " ")
        return np.stack(imgs), np.stack(cams16), prompt

    def batch(self, step: int, batch_size: int) -> Dict:
        """``batch_size`` scenes from item ``step * batch_size`` on,
        skipping those that cannot be read (an error once every scene has
        failed in a row); in training the azimuth ring starts at a fresh
        random angle, else at 0."""
        rng = np.random.default_rng(
            None if self.training else (self.seed, step)
        )
        images, cams, prompts = [], [], []
        i = (step * batch_size) % max(len(self.items), 1)
        failed = 0
        while len(images) < batch_size:
            if failed >= len(self.items):
                raise RuntimeError("no readable scene among the "
                                   f"{len(self.items)} listed")
            uid = self.items[i % len(self.items)]
            i += 1
            try:
                im, cm, pr = self._load_scene(uid, rng)
            except Exception:
                failed += 1
                continue
            failed = 0
            images.append(im)
            cams.append(cm)
            prompts.append(pr)
        return {
            "images": np.stack(images).astype(np.float32),
            "camera": np.stack(cams).astype(np.float32),
            "prompts": prompts,
        }
