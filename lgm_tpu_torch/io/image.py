"""Image files by their magic bytes, as ``native/dataload.cpp::decode_file``
(``:128-133``) tells them apart: PNG by its signature, JPEG by ``FF D8``;
each goes to the port's own reader (``io/png.py``, ``io/jpeg.py``). A file
that is neither raises ``ImageError`` naming what it is.

``read_rgba`` gives lgm_tpu's native decode (8-bit RGBA and whether the
file has alpha); ``imread`` / ``decode_cv2`` give what ``cv2.imread`` /
``cv2.imdecode`` with ``IMREAD_UNCHANGED`` give. Every error names the
file (or the upload) it is about.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lgm_tpu_torch.io import ImageError, jpeg, png

def _decode(how: str, data: bytes, name: str):
    if data[:8] == png.SIGNATURE:
        reader = png
    elif data[:2] == jpeg.SOI:
        reader = jpeg
    else:
        raise ImageError(f"{name} is an unknown format: only PNG and JPEG "
                         "inputs are read")
    try:
        return getattr(reader, how)(data)
    except ImageError as exc:
        raise type(exc)(f"{name}: {exc}") from None


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError as exc:
        raise ImageError(f"cannot read {path}: {exc}") from None


def decode_rgba(data: bytes, name: str = "the data"
                ) -> Tuple[np.ndarray, bool]:
    """PNG or JPEG bytes -> (uint8 RGBA [H, W, 4], has_alpha)."""
    return _decode("decode_rgba", data, name)


def decode_cv2(data: bytes, name: str = "the data") -> np.ndarray:
    """PNG or JPEG bytes -> what ``cv2.imdecode(..., IMREAD_UNCHANGED)``
    gives."""
    return _decode("decode_cv2", data, name)


def read_rgba(path: str) -> Tuple[np.ndarray, bool]:
    """``decode_rgba`` of a file; raises ``ImageError`` for a file no
    reader takes (missing, another format, refused, corrupt)."""
    return decode_rgba(_read(path), path)


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for a PNG or JPEG;
    raises ``ImageError`` where cv2 would return None or the reader
    refuses the file."""
    return decode_cv2(_read(path), path)
