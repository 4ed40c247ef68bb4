"""Training observability: scalar logging and image grids.

The package's own copy of ``lgm_tpu/utils/logging.py``: one append-only
JSONL stream (``<workspace>/metrics.jsonl``) with an optional TensorBoard
mirror, and GT-vs-prediction image grids (ref: main.py:114-136).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricLogger:
    """Append scalars to <workspace>/metrics.jsonl (+ optional TB)."""

    def __init__(self, workspace: str, tensorboard: bool = True):
        os.makedirs(workspace, exist_ok=True)
        self.path = os.path.join(workspace, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:  # tensorboard is optional: JSONL alone keeps every scalar
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(workspace, "tb"))
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "train"):
        rec = {"step": int(step), "ts": time.time()}
        rec.update({f"{prefix}/{k}": float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def save_image_grid(path: str, gt: np.ndarray, pred: np.ndarray) -> str:
    """Write a 2-row image grid (GT on top, prediction below; columns are
    the B*V views). gt/pred: [B, V, H, W, 3] float in [0, 1]. Written
    through OpenCV where it imports, else as ``<stem>.npy`` (uint8
    [2H, B*V*W, 3]). Returns the path written."""
    def row(x):
        b, v, h, w, c = x.shape
        return x.reshape(b * v, h, w, c).transpose(1, 0, 2, 3).reshape(
            h, b * v * w, c)

    grid = np.concatenate([row(np.asarray(gt)), row(np.asarray(pred))], 0)
    grid = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import cv2
    except ImportError:
        path = os.path.splitext(path)[0] + ".npy"
        np.save(path, grid)
        return path
    cv2.imwrite(path, grid[..., ::-1])  # RGB -> BGR for cv2
    return path
