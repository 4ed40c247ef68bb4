"""Baseline JPEG reading in the port's own code: the card host cannot be
assumed to have ``cv2``, PIL or ``libjpeg``.

The decoder is host C++ (``data/csrc/jpeg_decode.cpp``, written from ITU-T
T.81 and libjpeg's documented arithmetic, linking no image library), built
on first use by ``ops/_build.py::build_host`` and called through
``ctypes``, which releases the GIL, so decoder threads run in parallel. It
computes what libjpeg-turbo computes at its defaults bit for bit: the
``JDCT_ISLOW`` inverse DCT, fancy upsampling (h2v1, h2v2, h1v2) and the
``jdcolor.c`` YCbCr -> RGB tables, for sequential Huffman-coded files
(SOF0, SOF1) of 8-bit samples with one or three components at any
integral sampling factors, restart markers and 8- or 16-bit quantisation
tables. Two views of a decoded file:

- ``read_rgba``: 8-bit RGBA and ``has_alpha`` False, as
  ``native/dataload.cpp::decode_jpeg`` gives it (lgm_tpu's decode:
  ``out_color_space = JCS_RGB``, so a gray file is replicated);
- ``imread`` / ``decode_cv2``: what ``cv2.imread(path,
  cv2.IMREAD_UNCHANGED)`` returns: gray [H, W] or BGR [H, W, 3]. The EXIF
  orientation is not applied, as ``IMREAD_UNCHANGED`` does not apply it.

It refuses, with ``JpegError``, what it does not read: progressive,
lossless, hierarchical and arithmetic-coded files, 12-bit samples, CMYK /
YCCK (four components), DNL, non-interleaved scans of a colour image, and
truncated or corrupt data or a missing table.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lgm_tpu_torch.io import ImageError

SOI = b"\xff\xd8"
_SRC = Path(__file__).resolve().parents[1] / "data" / "csrc" / \
    "jpeg_decode.cpp"
_ERRLEN = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class JpegError(ImageError):
    """The file is not a JPEG this reader takes."""


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the C++ decoder."""
    global _lib
    with _lock:
        if _lib is None:
            from lgm_tpu_torch.ops._build import build_host

            lib = ctypes.CDLL(str(build_host(_SRC)))
            lib.jpeg_header.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_header.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 gray [H, W] or RGB [H, W, 3], as libjpeg-turbo
    decodes them to the file's own colour space."""
    if data[:2] != SOI:
        raise JpegError("not a JPEG (no SOI marker)")
    lib = load_library()
    err = ctypes.create_string_buffer(_ERRLEN)
    hwc = np.zeros(3, np.int32)
    if lib.jpeg_header(data, len(data), hwc.ctypes.data, err, _ERRLEN):
        raise JpegError(err.value.decode())
    h, w, c = (int(v) for v in hwc)
    out = np.empty((h, w, c), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, out.size, err,
                       _ERRLEN):
        raise JpegError(err.value.decode())
    return out[..., 0] if c == 1 else out


def decode_rgba(data: bytes) -> Tuple[np.ndarray, bool]:
    """JPEG bytes -> (uint8 RGBA [H, W, 4], False): libjpeg's ``JCS_RGB``
    output (gray replicated) with alpha 255."""
    img = decode(data)
    out = np.empty(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = img[..., None] if img.ndim == 2 else img
    out[..., 3] = 255
    return out, False


def decode_cv2(data: bytes) -> np.ndarray:
    """JPEG bytes -> what ``cv2.imdecode(..., IMREAD_UNCHANGED)`` gives:
    gray [H, W] or BGR [H, W, 3]."""
    img = decode(data)
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., ::-1])


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError as exc:
        raise JpegError(f"cannot read {path}: {exc}") from None


def read_rgba(path: str) -> Tuple[np.ndarray, bool]:
    """``decode_rgba`` of a file; raises ``JpegError`` for a file this
    reader does not take."""
    return decode_rgba(_read(path))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for a JPEG; raises
    ``JpegError`` where the reader refuses the file."""
    return decode_cv2(_read(path))
