"""Inference: image(s) -> Gaussians -> .ply + 360° orbit frames.

Port of ``lgm_tpu/infer.py`` (ref: infer.py:26-157). Two inputs:

- ``--mv-images a.png b.png c.png d.png``: four ready views at azimuth
  0/90/180/270 with their canonical Plücker rays;
- ``--image x.png``: one image through the diffusion front-end
  (``image_to_views``: background handling, recentring, ImageDream with
  30 steps at guidance 5.0, the view reorder ``[1, 2, 3, 0]``), from a
  diffusers-layout ``--diffusion-ckpt`` directory.

Then the LGM forward -> ``.ply`` -> a 180-frame orbit at the preset's
output size (flatsort, dup 32, with depth; kernel K2 per frame on the
card; K1 in the U-Nets).

Input files are PNGs or JPEGs (sequential or progressive), read by the
port's own readers (``io/image.py``: ``io/png.py``, ``io/jpeg.py``) with
``cv2.imread(..., IMREAD_UNCHANGED)``'s pixels, so the CLI runs where
``cv2`` is absent; any other format, and a JPEG the reader refuses
(arithmetic-coded, 12-bit, CMYK, ...), raises an error that names it. ``image_to_views`` and ``process`` take arrays. ``process`` writes the
orbit as mp4 through OpenCV where ``cv2`` imports; otherwise the frames
go to ``<stem>.frames.npy`` (uint8 [F, S, S, 3]), and the path written is
printed either way.

Run: python -m lgm_tpu_torch.infer big --mv-images a.png b.png c.png d.png
         --workspace out [--resume model.safetensors] [--device cuda]
     python -m lgm_tpu_torch.infer big --image x.png --diffusion-ckpt DIR
         --workspace out [--elevation 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from lgm_tpu_torch import trace
from lgm_tpu_torch.config import CONFIGS, Options
from lgm_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD
from lgm_tpu_torch.io import image as imageio
from lgm_tpu_torch.io.ply import save_ply
from lgm_tpu_torch.models.lgm import LGM
from lgm_tpu_torch.models.unet import use_full_float32
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.utils import camera
from lgm_tpu_torch.utils.image import recenter, rgba_to_rgb_white
from lgm_tpu_torch.utils.resize import resize
from lgm_tpu_torch.weights import load_reference_weights


def resolve_device(device: str) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; never a silent switch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def _load_rgba(path: str, size: int) -> np.ndarray:
    """[size, size, 3] float RGB on white bg (RGBA composited over white),
    resized as ``cv2.INTER_AREA`` does."""
    img = imageio.imread(path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        rgb, a = img[..., [2, 1, 0]], img[..., 3:4]
        img = rgb * a + (1 - a)
    else:
        img = img[..., [2, 1, 0]]
    return resize(img, (size, size), "area")


def remove_background(path: str) -> Optional[np.ndarray]:
    """BGRA float [H, W, 4] in [0, 1] from ``rembg`` where it imports,
    else None (ref: infer.py:13,78)."""
    try:
        import rembg
    except ImportError:
        return None
    bgr = imageio.imread(path)
    if bgr.ndim == 2:
        bgr = np.stack([bgr] * 3, axis=-1)
    out = rembg.remove(bgr[..., :3], session=rembg.new_session())
    return out.astype(np.float32) / 255.0


def image_to_views(pipe, image: np.ndarray, opt: Options,
                   elevation: float = 0.0) -> np.ndarray:
    """One image -> the four LGM input views [4, S, S, 3] in [0, 1], S =
    ``opt.input_size`` (``lgm_tpu/infer.py:352-381``).

    ``image`` is float in [0, 1] in OpenCV's channel order, as
    ``cv2.imread(..., IMREAD_UNCHANGED) / 255`` or ``remove_background``
    give it: [H, W, 4] BGRA (recentred on its alpha > 0 and composited
    over white) or [H, W, 3] BGR. ``pipe`` (an image-conditioned
    ``MVDreamPipeline``) makes its views with 30 steps at guidance 5.0;
    views 1, 2, 3, 0 are resized (linear) to S. A profiled run reads the
    whole call from the range ``views``."""
    with trace.span("views"):
        if image.shape[-1] == 4:
            rgba = image[..., [2, 1, 0, 3]]
            img = rgba_to_rgb_white(recenter(rgba, rgba[..., 3] > 0,
                                             border_ratio=0.2))
        else:
            img = image[..., [2, 1, 0]]
        mv = pipe(image=np.ascontiguousarray(img, np.float32), prompt="",
                  elevation=elevation, num_inference_steps=30,
                  guidance_scale=5.0)
        s = opt.input_size
        return np.stack([resize(m, (s, s), "linear")
                         for m in mv[[1, 2, 3, 0]]])


def build_input(mv_images: np.ndarray, opt: Options) -> np.ndarray:
    """[4, H, W, 3] RGB -> [1, 4, H, W, 9] network input with canonical
    orbit-view Plücker rays (ref: core/models.py:61-85)."""
    imgs = (mv_images - IMAGENET_MEAN) / IMAGENET_STD
    emb, _ = camera.default_plucker_embedding(opt)
    return np.concatenate([imgs, emb], axis=-1)[None].astype(np.float32)


def orbit_video_cameras(opt: Options, n_frames: int, elevation: float = 0.0):
    poses = np.stack([
        camera.orbit_camera(elevation, az, opt.cam_radius)
        for az in np.linspace(0, 360, n_frames, endpoint=False)
    ])
    return camera.build_camera_inputs(poses, opt.fovy, opt.znear, opt.zfar)


def orbit_split(n_frames: int, chunk: int, fancy: bool,
                n_devices: Optional[int], dev: torch.device):
    """(devices, chunk) of an orbit render, by ``lgm_tpu/infer.py``'s
    rules: by default every CUDA card (``torch.cuda.device_count()``), 1
    on the CPU; ``fancy`` (one frame at a time) forces 1; at most one
    device a frame; ``chunk`` rounded down to a multiple of the devices
    (at least one frame each)."""
    if fancy:
        n_devices = 1
    elif n_devices is None:
        n_devices = (max(1, torch.cuda.device_count()) if dev.type == "cuda"
                     else 1)
    if n_devices > 1:
        n_devices = min(n_devices, n_frames)
        if chunk % n_devices:
            chunk = max(n_devices, chunk - chunk % n_devices)
    return n_devices, chunk


def render_orbit_video(gaussians, opt: Options, n_frames: int = 180,
                       chunk: int = 30, fancy: bool = False,
                       device: str = "cuda",
                       n_devices: Optional[int] = None) -> np.ndarray:
    """Render a 360° orbit of [N, 14] Gaussians: uint8 [n_frames, S, S, 3].
    Frames are rendered ``chunk`` at a time and moved to the host as
    uint8 (the range ``orbit.to_host`` of a profiled run); ``fancy`` ramps
    the scale modifier from 0 to 1 over the first quarter (ref:
    infer.py:113-130). ``process`` writes the result.

    Several cards (``orbit_split``: all of them by default on CUDA): each
    chunk's frames are split evenly over ``cuda:0 … cuda:n−1`` in order,
    each card rendering its share from its own copy of the Gaussians, one
    host thread a card; the frames come back in order. On the CPU,
    ``n_devices`` > 1 splits the chunk the same way on the one device."""
    dev = resolve_device(device)
    n, chunk = orbit_split(n_frames, chunk, fancy, n_devices, dev)
    devices = ([torch.device("cuda", i) for i in range(n)]
               if dev.type == "cuda" and n > 1 else [dev] * n)
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    cams = torch.as_tensor(orbit_video_cameras(opt, n_frames)["cam_view"])
    g = torch.tensor(np.asarray(gaussians), dtype=torch.float32)[None]
    copies = {d: (g.to(d), cams.to(d)) for d in set(devices)}

    def frames(d, lo, hi, sm):
        g_d, cams_d = copies[d]
        on_card = (torch.cuda.device(d) if d.type == "cuda"
                   else contextlib.nullcontext())
        with torch.inference_mode(), on_card:
            img = render_views(g_d, cams_d[lo:hi][None], opt.output_size,
                               tan, scale_modifier=sm, dup=32)["image"][0]
            # x255 then truncation toward zero, as the JAX path's astype.
            with trace.span("orbit.to_host"):
                return (img * 255.0).to(torch.uint8).cpu().numpy()

    outs = []
    pool = ThreadPoolExecutor(n) if n > 1 else None
    try:
        for s in range(0, n_frames, chunk):
            e = min(s + chunk, n_frames)
            if fancy:
                outs += [frames(dev, i, i + 1, min(1.0, 4.0 * i / n_frames))
                         for i in range(s, e)]
            else:
                per = chunk // n
                parts = [(d, s + i * per, min(s + (i + 1) * per, e))
                         for i, d in enumerate(devices) if s + i * per < e]
                outs += (pool.map if pool else map)(
                    lambda a: frames(*a, 1.0), parts)
    finally:
        if pool is not None:
            pool.shutdown()
    return np.concatenate(outs)


def write_video(out_path: str, video: np.ndarray, fps: int) -> str:
    """mp4 through OpenCV where it imports, else ``<stem>.frames.npy``.
    Returns the path written."""
    try:
        import cv2
    except ImportError:
        path = os.path.splitext(out_path)[0] + ".frames.npy"
        np.save(path, video)
        return path
    h, w = video.shape[1:3]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {out_path}")
    for frame in video:
        writer.write(frame[..., ::-1])  # RGB -> BGR
    writer.release()
    return out_path


def load_model(opt: Options, resume: Optional[str] = None,
               device: str = "cuda") -> LGM:
    """The LGM in eval mode on ``device``, in the preset's compute dtype
    (``mixed_precision``: bf16 or fp32). Weights come from ``resume`` (a
    reference ``.safetensors``/``.pt`` state dict, or a ``ckpt_N`` that
    ``lgm_tpu_torch.train`` wrote) or, without one, from
    PyTorch's default initialization under seed 0 (the released
    checkpoint is not in the repository)."""
    dev = resolve_device(device)
    use_full_float32()
    dtype = torch.bfloat16 if opt.mixed_precision == "bf16" else torch.float32
    rng_devices = ([torch.cuda.current_device() if dev.index is None
                    else dev.index] if dev.type == "cuda" else [])
    with torch.random.fork_rng(devices=rng_devices):
        torch.manual_seed(0)
        with dev:
            model = LGM(opt, dtype=dtype)
    if resume:
        load_reference_weights(model, resume)
    return model.eval()


def forward_gaussians(model: LGM, mv_images: np.ndarray) -> np.ndarray:
    """[4, H, W, 3] views in [0, 1] -> Gaussians [1, 4 * splat^2, 14]."""
    dev = next(model.parameters()).device
    inp = torch.as_tensor(build_input(mv_images, model.opt), device=dev)
    with torch.inference_mode():
        return model(inp).float().cpu().numpy()


def process(opt: Options, mv_images: np.ndarray, out_stem: str,
            resume: Optional[str] = None, device: str = "cuda",
            model: Optional[LGM] = None) -> dict:
    """mv_images [4, H, W, 3] in [0, 1] -> writes ``<stem>.ply`` and the
    orbit. Returns a dict: ``gaussians`` [1, N, 14], ``frames`` uint8, and
    the ``ply`` and ``video`` paths. A profiled run reads the forward and
    the orbit from the ranges ``lgm`` and ``render``."""
    resolve_device(device)
    if model is None:
        model = load_model(opt, resume, device)
    gaussians = forward_gaussians(model, mv_images)
    ply_path = out_stem + ".ply"
    save_ply(gaussians, ply_path)
    frames = render_orbit_video(gaussians[0], opt, fancy=opt.fancy_video,
                                device=device)
    video = write_video(out_stem + ".mp4", frames, fps=30)
    print(f"wrote {ply_path} and {video}")
    return {"gaussians": gaussians, "frames": frames, "ply": ply_path,
            "video": video}


def main(argv=None):
    parser = argparse.ArgumentParser(description="lgm_tpu_torch inference")
    parser.add_argument("config", nargs="?", default="big",
                        choices=sorted(CONFIGS))
    parser.add_argument("--resume", type=str, default=None,
                        help="reference .safetensors/.pt state dict, or a "
                        "ckpt_N of lgm_tpu_torch.train")
    parser.add_argument("--workspace", type=str, default="./workspace")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--image", type=str, default=None,
                        help="one input image (runs the diffusion "
                        "front-end)")
    source.add_argument("--mv-images", nargs=4, default=None,
                        help="four multi-view images at az 0/90/180/270")
    parser.add_argument("--diffusion-ckpt", type=str, default=None,
                        help="diffusers-layout ImageDream directory")
    parser.add_argument("--elevation", type=float, default=0.0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fancy-video", action="store_true")
    ns = parser.parse_args(argv)

    opt = CONFIGS[ns.config]
    if ns.fancy_video:
        opt = opt.replace(fancy_video=True)
    resolve_device(ns.device)
    os.makedirs(ns.workspace, exist_ok=True)
    first = ns.image or ns.mv_images[0]
    stem = os.path.join(ns.workspace,
                        os.path.splitext(os.path.basename(first))[0])
    if ns.mv_images:
        mv = np.stack([_load_rgba(p, opt.input_size) for p in ns.mv_images])
    else:
        from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline

        image = remove_background(ns.image)
        if image is None:
            image = imageio.imread(ns.image).astype(np.float32) / 255.0
        pipe = MVDreamPipeline.from_pretrained(ns.diffusion_ckpt,
                                               device=ns.device)
        mv = image_to_views(pipe, image, opt, ns.elevation)
    process(opt, mv, stem, resume=ns.resume, device=ns.device)


if __name__ == "__main__":
    main()
