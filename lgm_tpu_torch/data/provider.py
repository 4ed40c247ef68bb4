"""Disk data providers for Objaverse- and LVIS-layout renderings.

Port of ``lgm_tpu/data/provider.py`` (NHWC numpy samples, the same data
contract as ``data/synthetic.py``):

- ``ObjaverseDataset`` (ref: core/provider_objaverse.py:20-172): object
  directories ``<uid>/rgb/NNN.png`` (RGBA) + ``<uid>/pose/NNN.txt`` (16
  c2w floats, Blender world and OpenCV camera); training draws the input
  views from the 36..72 azimuth ring and random supervision views.
- ``LVISDataset`` (ref: core/provider_lvis.py:23-218): split directories
  (the test split ``40000-49999`` left out) of scene directories with
  ``NNN.png`` + ``NNN.npy`` ({elevation, azimuth, radius}); input views
  1..V_in, pose ``orbit_camera(-elevation, azimuth, radius)``.

Both decode through ``data/decode.py`` (the counterpart of lgm_tpu's
default native path, ``native.load_views``): a chunk of candidate views at
a time, unreadable ones skipped and the tail padded by repetition. Then
``build_sample_preresized``: pose 0 canonicalised, grid distortion and
camera jitter on the non-first input views (training), ImageNet
normalisation, Plücker rays, the rasterizer's cameras.

Training samples draw from ``np.random.default_rng(None)``; evaluation
samples from ``(7, idx)`` (Objaverse) or ``(13, idx)`` (LVIS), as in
lgm_tpu. The datasets are ``torch.utils.data.Dataset``s, and ``Loader`` is
a ``DataLoader`` with worker processes (the reference's idiom, main.py:
52-70) whose batch sampler gives lgm_tpu's ``Loader`` order: a
``default_rng((seed, epoch))`` shuffle, whole batches, in order; each dp
rank takes its slice of every global batch.
"""

from __future__ import annotations

import collections
import glob
import itertools
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from lgm_tpu_torch.config import Options
from lgm_tpu_torch.data.decode import load_views
from lgm_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD
from lgm_tpu_torch.io import jpeg, png
from lgm_tpu_torch.utils import camera
from lgm_tpu_torch.utils.augment import grid_distortion, orbit_camera_jitter
from lgm_tpu_torch.utils.resize import resize


def _resize(imgs: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize [V, H, W, C] -> [V, size, size, C] (OpenCV's
    ``INTER_LINEAR``)."""
    if imgs.shape[1] == size:
        return imgs
    return np.stack([resize(im, (size, size), "linear")
                     .reshape(size, size, -1) for im in imgs])


def build_sample(images: np.ndarray, masks: np.ndarray,
                 cam_poses: np.ndarray, opt: Options, training: bool,
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """images [V, H, W, 3] white-background RGB in [0, 1], masks [V, H,
    W], cam_poses [V, 4, 4] OpenGL c2w -> the provider contract dict."""
    return build_sample_preresized(
        _resize(images[: opt.num_input_views], opt.input_size),
        _resize(images, opt.output_size),
        _resize(masks[..., None], opt.output_size),
        cam_poses, opt, training, rng,
    )


def build_sample_preresized(
        images_input: np.ndarray, images_output: np.ndarray,
        masks_output: np.ndarray, cam_poses: np.ndarray, opt: Options,
        training: bool, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The assembly with the resizes done: images_input [V_in, in_S, in_S,
    3], images_output [V, out_S, out_S, 3], masks_output [V, out_S, out_S,
    1], all white-background RGB in [0, 1]; cam_poses [V, 4, 4] OpenGL
    c2w."""
    V_in = opt.num_input_views
    cam_poses = np.asarray(camera.canonicalize_poses(cam_poses,
                                                     opt.cam_radius))

    images_input = np.array(images_input[:V_in])  # augmented in place
    poses_input = cam_poses[:V_in].copy()

    if training:
        if rng.random() < opt.prob_grid_distortion:
            images_input[1:] = grid_distortion(images_input[1:], rng=rng)
        if rng.random() < opt.prob_cam_jitter:
            poses_input[1:] = orbit_camera_jitter(poses_input[1:], rng=rng)

    images_input = (images_input - IMAGENET_MEAN) / IMAGENET_STD
    plucker = np.stack([
        camera.plucker_rays(p, opt.input_size, opt.input_size, opt.fovy)
        for p in poses_input]).astype(np.float32)
    final_input = np.concatenate([images_input, plucker], axis=-1)

    cams = camera.build_camera_inputs(cam_poses, opt.fovy, opt.znear,
                                      opt.zfar)
    return {
        "input": final_input.astype(np.float32),
        "images_output": np.asarray(images_output, np.float32),
        "masks_output": np.asarray(masks_output, np.float32),
        "cam_view": np.asarray(cams["cam_view"], np.float32),
        "cam_view_proj": np.asarray(cams["cam_view_proj"], np.float32),
        "cam_pos": np.asarray(cams["cam_pos"], np.float32),
    }


class _DecodeCache:
    """Opt-in LRU over decoded views, keyed by (path, out_size, in_size),
    budget ``LGM_TPU_DECODE_CACHE_MB`` (0 or unset: off), as lgm_tpu's.
    It caches the white-background composite and both resizes, so every
    per-sample random choice (views, grid distortion, camera jitter) stays
    downstream and the cached path gives the uncached one's samples. It
    stores copies that own their memory (lgm_tpu's stores views into a
    whole chunk's arrays, which keeps the chunk alive). Under ``Loader``
    each worker process holds its own cache."""

    def __init__(self, budget_mb: int):
        self.budget = budget_mb * (1 << 20)
        self.used = 0
        self.lock = threading.Lock()
        self.data: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key):
        with self.lock:
            val = self.data.get(key)
            if val is not None:
                self.data.move_to_end(key)
            return val

    def put(self, key, val):
        val = tuple(np.array(a) for a in val)
        nbytes = sum(a.nbytes for a in val)
        with self.lock:
            if key in self.data or nbytes > self.budget:
                return
            self.data[key] = val
            self.used += nbytes
            while self.used > self.budget:
                _, old = self.data.popitem(last=False)
                self.used -= sum(a.nbytes for a in old)


_decode_cache: Optional[_DecodeCache] = None
_decode_cache_mb = -1


def _get_decode_cache() -> Optional[_DecodeCache]:
    global _decode_cache, _decode_cache_mb
    mb = int(os.environ.get("LGM_TPU_DECODE_CACHE_MB", "0") or "0")
    if mb != _decode_cache_mb:  # the budget changed (tests toggle it)
        _decode_cache_mb = mb
        _decode_cache = _DecodeCache(mb) if mb > 0 else None
    return _decode_cache


def _decode_threads(n: int) -> int:
    """Threads to decode ``n`` views: up to 4 in this process, 1 in a
    loader worker (the workers are the parallelism there)."""
    return 1 if torch.utils.data.get_worker_info() is not None else min(4, n)


def _load_views_cached(paths: List[str], out_size: int, in_size: int):
    """``load_views`` behind the decode LRU: only misses are decoded.
    Returns per-path lists ([rgb_out], [mask_out], [rgb_in], [ok])."""
    cache = _get_decode_cache()
    if cache is None:
        rgb_o, mask_o, rgb_i, _, ok = load_views(
            paths, out_size, in_size, n_threads=_decode_threads(len(paths)))
        return rgb_o, mask_o, rgb_i, ok

    n = len(paths)
    rgb_o, mask_o, rgb_i = [None] * n, [None] * n, [None] * n
    ok = [False] * n
    miss = []
    for j, p in enumerate(paths):
        hit = cache.get((p, out_size, in_size))
        if hit is not None:
            rgb_o[j], mask_o[j], rgb_i[j] = hit
            ok[j] = True
        else:
            miss.append(j)
    if miss:
        ro, mo, ri, _, mok = load_views(
            [paths[j] for j in miss], out_size, in_size,
            n_threads=_decode_threads(len(miss)))
        for k, j in enumerate(miss):
            ok[j] = bool(mok[k])
            if ok[j]:
                rgb_o[j], mask_o[j], rgb_i[j] = ro[k], mo[k], ri[k]
                cache.put((paths[j], out_size, in_size),
                          (ro[k], mo[k], ri[k]))
    return rgb_o, mask_o, rgb_i, ok


def _decoded_sample(opt: Options, training: bool, rng: np.random.Generator,
                    candidates: Iterator[Tuple[str, np.ndarray]],
                    ) -> Dict[str, np.ndarray]:
    """One sample from ``candidates`` (image path, parsed c2w), decoded a
    chunk at a time (two slack views a chunk absorb failures); unreadable
    views are skipped and the tail padded by repetition (ref:
    provider_objaverse.py:83-91,115-120; lgm_tpu's ``_native_sample``)."""
    V = opt.num_views
    imgs_in: List[np.ndarray] = []
    imgs_out: List[np.ndarray] = []
    masks_out: List[np.ndarray] = []
    poses: List[np.ndarray] = []
    it = iter(candidates)
    while len(poses) < V:
        chunk = list(itertools.islice(it, V - len(poses) + 2))
        if not chunk:
            break
        rgb_o, mask_o, rgb_i, ok = _load_views_cached(
            [p for p, _ in chunk], opt.output_size, opt.input_size)
        for j, good in enumerate(ok):
            if good and len(poses) < V:
                imgs_out.append(rgb_o[j])
                masks_out.append(mask_o[j])
                imgs_in.append(rgb_i[j])
                poses.append(chunk[j][1])
    if not poses:
        raise RuntimeError("no readable views")
    while len(poses) < V:  # pad by repetition
        imgs_out.append(imgs_out[-1])
        masks_out.append(masks_out[-1])
        imgs_in.append(imgs_in[-1])
        poses.append(poses[-1])
    return build_sample_preresized(
        np.stack(imgs_in[: opt.num_input_views]), np.stack(imgs_out),
        np.stack(masks_out)[..., None], np.stack(poses), opt, training, rng)


class ObjaverseDataset(Dataset):
    """rgb/NNN.png + pose/NNN.txt per object (ref provider #7)."""

    def __init__(self, opt: Options, training: bool = True,
                 items: Optional[List[str]] = None):
        self.opt = opt
        self.training = training
        if items is None:
            assert opt.data_path, "set --data-path to the objaverse root"
            items = sorted(p for p in glob.glob(os.path.join(opt.data_path,
                                                             "*"))
                           if os.path.isdir(p))
        # naive split (ref: provider_objaverse.py:39-43)
        if training:
            self.items = items[: -opt.batch_size]
        else:
            self.items = items[-opt.batch_size:]

    def __len__(self):
        return len(self.items)

    @staticmethod
    def _parse_pose(cpath: str, cam_radius: float) -> np.ndarray:
        """Blender world + OpenCV camera -> OpenGL world and camera (ref:
        provider_objaverse.py:94-97)."""
        with open(cpath) as f:
            c2w = np.array([float(t) for t in f.read().strip().split()],
                           np.float32).reshape(4, 4)
        c2w[1] *= -1
        c2w[[1, 2]] = c2w[[2, 1]]
        c2w[:3, 1:3] *= -1
        c2w[:3, 3] *= cam_radius / 1.5
        return c2w

    def _candidates(self, uid: str, vids):
        for vid in vids:
            cpath = os.path.join(uid, "pose", f"{vid:03d}.txt")
            try:
                c2w = self._parse_pose(cpath, self.opt.cam_radius)
            except Exception:
                continue
            yield os.path.join(uid, "rgb", f"{vid:03d}.png"), c2w

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        opt = self.opt
        uid = self.items[idx]
        rng = np.random.default_rng(None if self.training else (7, idx))
        if self.training:
            vids = (list(rng.permutation(np.arange(36, 73))
                         [: opt.num_input_views])
                    + list(rng.permutation(100)))
        else:
            vids = list(np.arange(36, 73, 4)) + list(np.arange(100))
        return _decoded_sample(opt, self.training, rng,
                               self._candidates(uid, vids))


class LVISDataset(Dataset):
    """NNN.png + NNN.npy per scene under split dirs (ref provider #8)."""

    TEST_SPLITS = ("40000-49999",)

    def __init__(self, opt: Options, training: bool = True,
                 scene_dirs: Optional[List[str]] = None):
        self.opt = opt
        self.training = training
        if scene_dirs is None:
            root = opt.data_path_rendering or opt.data_path
            assert root, "set --data-path-rendering to the LVIS root"
            splits = [s for s in sorted(os.listdir(root))
                      if s not in self.TEST_SPLITS
                      and os.path.isdir(os.path.join(root, s))]
            scene_dirs = []
            for s in splits:
                scene_dirs.extend(sorted(
                    p for p in glob.glob(os.path.join(root, s, "*"))
                    if os.path.isdir(p)))
        if training:
            self.items = scene_dirs[: -opt.batch_size]
        else:
            self.items = scene_dirs[-opt.batch_size:]

    def __len__(self):
        return len(self.items)

    def _parse_pose(self, cpath: str) -> np.ndarray:
        # The elevation's sign flips (ref: provider_lvis.py:134).
        cam = np.load(cpath, allow_pickle=True).item()
        c2w = camera.orbit_camera(-cam["elevation"], cam["azimuth"],
                                  radius=cam["radius"])
        c2w[:3, 3] *= self.opt.cam_radius / 1.5
        return c2w

    def _candidates(self, uid: str, vids):
        for vid in vids:
            cpath = os.path.join(uid, f"{vid:03d}.npy")
            try:
                c2w = self._parse_pose(cpath)
            except Exception:
                continue
            yield os.path.join(uid, f"{vid:03d}.png"), c2w

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        opt = self.opt
        uid = self.items[idx]
        rng = np.random.default_rng(None if self.training else (13, idx))
        files = sorted(glob.glob(os.path.join(uid, "*.png")))
        max_vid = max(
            int("".join(c for c in os.path.splitext(os.path.basename(f))[0]
                        if c.isdigit()))
            for f in files)
        fixed = list(range(1, 1 + opt.num_input_views))
        if self.training:
            vids = fixed + list(rng.permutation(max_vid + 1))
        else:
            vids = fixed + list(np.arange(max_vid + 1))
        return _decoded_sample(opt, self.training, rng,
                               self._candidates(uid, vids))


class BatchSampler(Sampler):
    """lgm_tpu ``Loader``'s batches of ``n`` indices: a
    ``default_rng((0, epoch))`` shuffle when ``shuffle``, whole batches of
    ``batch_size`` in order (a short last one dropped); each yields rank
    ``rank`` of ``ranks``'s equal slice. It runs through the epoch
    ``set_epoch`` picks, or, when ``endless``, through that epoch and
    every later one in turn."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 rank: int = 0, ranks: int = 1, endless: bool = False):
        if batch_size % ranks:
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{ranks} ranks")
        self.n, self.bs, self.shuffle = n, batch_size, shuffle
        self.rank, self.ranks, self.endless = rank, ranks, endless
        self.epoch = 0

    def __len__(self):
        return self.n // self.bs

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        epochs = (itertools.count(self.epoch) if self.endless
                  else (self.epoch,))
        for epoch in epochs:
            idx = np.arange(self.n)
            if self.shuffle:
                np.random.default_rng((0, epoch)).shuffle(idx)
            k = self.bs // self.ranks
            for b in range(len(self)):
                sel = idx[b * self.bs + self.rank * k:][:k]
                yield [int(i) for i in sel]


class Loader:
    """Batches of a dataset over ``workers`` worker processes (0: in this
    process), in lgm_tpu's ``Loader`` order (``BatchSampler``), each the
    dp rank ``rank``'s slice of ``ranks``; a worker makes a whole batch,
    one ahead, stacked by ``default_collate`` straight into shared memory;
    pinned host memory with ``pin_memory``. With
    ``endless``, ``epoch(e)`` runs on through the later epochs, so the
    workers prefetch across an epoch's end; otherwise no more workers
    start than an epoch has batches. The workers are spawned, not forked
    (the trainer's process has threads: CUDA's, the process group's), and
    live until ``close``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 workers: int = 8, rank: int = 0, ranks: int = 1,
                 pin_memory: bool = False, endless: bool = False):
        # The C++ unfilter and JPEG decoder are built here, before any
        # worker starts.
        png.load_library()
        jpeg.load_library()
        self.sampler = BatchSampler(len(dataset), batch_size, shuffle, rank,
                                    ranks, endless)
        if not endless:
            workers = min(workers, len(self.sampler))
        self.loader = DataLoader(
            dataset, batch_sampler=self.sampler, num_workers=workers,
            pin_memory=pin_memory,
            persistent_workers=workers > 0,
            multiprocessing_context="spawn" if workers > 0 else None,
            prefetch_factor=1 if workers > 0 else None)

    def __len__(self):
        return len(self.sampler)

    def epoch(self, epoch: int = 0):
        """The batches of epoch ``epoch`` (and on, when ``endless``), in
        order."""
        self.sampler.set_epoch(epoch)
        return iter(self.loader)

    def close(self) -> None:
        """Stop the worker processes: hand out no more batches, take the
        ones in flight (a worker stopped in the middle of one aborts),
        then shut the workers down."""
        it = self.loader._iterator
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._sampler_iter = iter(())
            for _ in it:
                pass
            it._shutdown_workers()
        self.loader._iterator = None
