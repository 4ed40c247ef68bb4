"""PNG reading and writing in the port's own code, which relies on no
``cv2``, PIL or ``libpng`` (a host may lack each; the card host has no
``libpng``).

The reader parses the chunks in Python, inflates the image data with the
standard library's ``zlib`` and undoes the scanline filters in host C++
(``data/csrc/png_unfilter.cpp``, built on first use by
``ops/_build.py::build_host`` and called through ``ctypes``, which
releases the GIL, so decoder threads run in parallel). Sub, Average and
Paeth predict each byte from the reconstructed byte to its left, so a row
cannot be vectorised; ``unfilter_plain`` is the numpy version the tests
hold the C++ against, and nothing on the decode path calls it.

It takes colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and
6 (RGBA) at 8 bits, gray and palette also at 1, 2 and 4 bits, with
``tRNS`` transparency, not interlaced. Two views of a decoded file:

- ``read_rgba``: 8-bit RGBA and whether the file has alpha (an alpha
  channel or ``tRNS``), as libpng's simplified API gives it for
  ``PNG_FORMAT_RGBA``, the format ``native/dataload.cpp::decode_png`` asks
  for (lgm_tpu's decode);
- ``imread``: what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns: gray
  [H, W] (a gray ``tRNS`` is dropped), BGR [H, W, 3], or BGRA [H, W, 4]
  for gray + alpha, RGBA and files with ``tRNS``.

Both agree with their reference bit for bit on every file the reader
takes. It refuses, with ``PngError``, what those two decoders would not
give alike or what it does not read: 16-bit samples (libpng's simplified
API converts them as linear light to sRGB, cv2 keeps 16 bits), interlaced
files, an ``iCCP`` profile, a ``gAMA`` that libpng's simplified API would
correct (one that is not within 5% of sRGB's 1/2.2 after its own
rounding; cv2 applies none), ``tRNS`` beside an alpha channel, palette
indices past the palette, unknown critical chunks, a CRC mismatch, and
missing, truncated or corrupt data.

The writer (``encode`` / ``write``) picks a filter per row by libpng's
heuristic, the smallest sum of the filtered bytes taken as signed, or the
one it is given; encoding filters read the raw bytes only, so it is
vectorised.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lgm_tpu_torch.io import ImageError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SRC = Path(__file__).resolve().parents[1] / "data" / "csrc" / \
    "png_unfilter.cpp"
# Channels of each colour type before palette expansion.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# The largest image the reader allocates (pixels).
_MAX_PIXELS = 1 << 26

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class PngError(ImageError):
    """The file is not a PNG this reader takes."""


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the C++ unfilter."""
    global _lib
    with _lock:
        if _lib is None:
            from lgm_tpu_torch.ops._build import build_host

            lib = ctypes.CDLL(str(build_host(_SRC)))
            lib.png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
        return _lib


def unfilter(data: np.ndarray, height: int, rowbytes: int,
             bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``height`` rows of ``1 + rowbytes``
    bytes (uint8, C order) with the C++ loop: uint8 [height, rowbytes]."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.size < height * (rowbytes + 1):
        raise PngError("image data is short")
    out = np.empty((height, rowbytes), np.uint8)
    rc = load_library().png_unfilter(data.ctypes.data, out.ctypes.data,
                                      height, rowbytes, bpp)
    if rc != 0:
        raise PngError("unknown filter type")
    return out


def unfilter_plain(data: np.ndarray, height: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """``unfilter`` in numpy (a loop over rows, and over pixels for the
    Average and Paeth filters): the plain version the tests hold the C++
    against."""
    rows = np.asarray(data, np.uint8)[:height * (rowbytes + 1)].reshape(
        height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int32)
    for y in range(height):
        ftype, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            row = src
        elif ftype == 1:
            # Each byte adds the one bpp to its left: a running sum mod 256
            # in each byte lane.
            pad = -rowbytes % bpp
            lanes = np.concatenate([src, np.zeros(pad, np.int32)])
            row = (np.cumsum(lanes.reshape(-1, bpp), axis=0) % 256
                   ).reshape(-1)[:rowbytes]
        elif ftype == 2:
            row = (src + prev) % 256
        elif ftype in (3, 4):
            row = np.zeros(rowbytes, np.int32)
            for x in range(rowbytes):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pred = _paeth(a, b, c)
                row[x] = (src[x] + pred) % 256
        else:
            raise PngError("unknown filter type")
        out[y] = row
        prev = row.astype(np.int32)
    return out


def _paeth(a, b, c):
    """The Paeth predictor, on scalars or (vectorised) on arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _gamma_not_srgb(gamma: int) -> bool:
    """libpng's ``png_gamma_not_sRGB`` for a ``gAMA`` value (1e5 = 1.0):
    whether the simplified API corrects the samples."""
    if gamma >= 100000:
        return True
    if gamma == 0:
        return False
    g = (gamma * 11 + 2) // 5   # x 2.2, rounded
    return g < 95000 or g > 105000


class _Image:
    """A decoded file: samples uint8 [H, W, C] before palette expansion,
    the colour type and bit depth, the palette [N, 3], the palette's alpha
    [N] and the gray or RGB transparent key (at the file's bit depth)."""

    def __init__(self, samples, color_type, depth, palette, palette_alpha,
                 key):
        self.samples = samples
        self.color_type = color_type
        self.depth = depth
        self.palette = palette
        self.palette_alpha = palette_alpha
        self.key = key


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise PngError("truncated before IEND")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise PngError(f"truncated {ctype!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:end])[0]
        if zlib.crc32(ctype + body) != crc:
            raise PngError(f"CRC mismatch in {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end


def _decode(data: bytes, unfilter_fn=unfilter) -> _Image:
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG (no PNG signature)")
    header = None
    palette = palette_alpha = key = None
    trns = None
    idat = []
    for ctype, body in _chunks(data):
        if header is None and ctype != b"IHDR":
            raise PngError("first chunk is not IHDR")
        if ctype == b"IHDR":
            if len(body) != 13 or header is not None:
                raise PngError("bad IHDR")
            header = struct.unpack(">IIBBBBB", body)
            width, height, depth, ctype_, comp, filt, interlace = header
            if ctype_ not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
                raise PngError(f"bad colour type {ctype_} / depth {depth}")
            if depth == 16:
                raise PngError("16-bit samples are not read")
            if depth not in _DEPTHS[ctype_]:
                raise PngError(f"bad colour type {ctype_} / depth {depth}")
            if comp != 0 or filt != 0:
                raise PngError("unknown compression or filter method")
            if interlace != 0:
                raise PngError("interlaced files are not read")
            if not 0 < width * height <= _MAX_PIXELS:
                raise PngError(f"bad size {width}x{height}")
        elif ctype == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise PngError("bad PLTE")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"gAMA":
            if len(body) != 4:
                raise PngError("bad gAMA")
            if _gamma_not_srgb(struct.unpack(">I", body)[0]):
                raise PngError("gAMA other than sRGB's is not read")
        elif ctype == b"iCCP":
            raise PngError("iCCP profiles are not read")
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif not ctype[0] & 0x20:   # critical
            raise PngError(f"unknown critical chunk {ctype!r}")
    width, height, depth, color_type = header[:4]
    if color_type == 3 and palette is None:
        raise PngError("palette image without PLTE")
    if trns is not None:
        if color_type == 0 and len(trns) == 2:
            key = (struct.unpack(">H", trns)[0],)
        elif color_type == 2 and len(trns) == 6:
            key = struct.unpack(">HHH", trns)
        elif color_type == 3 and len(trns) <= len(palette):
            palette_alpha = np.full(len(palette), 255, np.uint8)
            palette_alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        else:
            raise PngError(f"bad tRNS for colour type {color_type}")
    channels = _CHANNELS[color_type]
    rowbytes = (width * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise PngError(f"corrupt image data: {exc}") from None
    if len(raw) < height * (rowbytes + 1):
        raise PngError("image data is short")
    rows = unfilter_fn(np.frombuffer(raw, np.uint8), height, rowbytes,
                       max(1, channels * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :width * depth]
        bits = bits.reshape(height, width, depth).astype(np.uint8)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(-1, dtype=np.uint8)[..., None]
    else:
        samples = rows[:, :width * channels].reshape(height, width,
                                                     channels)
    if color_type == 3 and int(samples.max()) >= len(palette):
        raise PngError("palette index past the palette")
    return _Image(samples, color_type, depth, palette, palette_alpha,
                  key)


def _gray8(img: _Image) -> np.ndarray:
    """Gray samples at 1-8 bits scaled to 8 (x255, x85, x17, x1)."""
    return img.samples[..., 0] * np.uint8(255 // ((1 << img.depth) - 1))


def _key_alpha(img: _Image, values: np.ndarray) -> np.ndarray:
    """255, or 0 where the samples equal the tRNS key."""
    match = np.all(values == np.asarray(img.key, values.dtype), axis=-1)
    return np.where(match, 0, 255).astype(np.uint8)


def _rgba(img: _Image) -> Tuple[np.ndarray, bool]:
    h, w = img.samples.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    ct = img.color_type
    if ct == 3:
        idx = img.samples[..., 0]
        out[..., :3] = img.palette[idx]
        alpha = img.palette_alpha
        out[..., 3] = 255 if alpha is None else alpha[idx]
        return out, alpha is not None
    if ct in (0, 4):
        gray = _gray8(img) if ct == 0 else img.samples[..., 0]
        out[..., :3] = gray[..., None]
    else:
        out[..., :3] = img.samples[..., :3]
    if ct in (4, 6):
        out[..., 3] = img.samples[..., -1]
        return out, True
    if img.key is not None:
        out[..., 3] = _key_alpha(img, img.samples.astype(np.uint16))
        return out, True
    out[..., 3] = 255
    return out, False


def decode_rgba(data: bytes, unfilter_fn=unfilter
                ) -> Tuple[np.ndarray, bool]:
    """PNG bytes -> (uint8 RGBA [H, W, 4], has_alpha), libpng's
    simplified API with ``PNG_FORMAT_RGBA``: gray is replicated, a palette
    looked up, ``tRNS`` made alpha; alpha is 255 where the file has
    none."""
    return _rgba(_decode(data, unfilter_fn))


def decode_cv2(data: bytes, unfilter_fn=unfilter) -> np.ndarray:
    """PNG bytes -> what ``cv2.imread(..., IMREAD_UNCHANGED)`` gives for
    the file (see the module docstring)."""
    img = _decode(data, unfilter_fn)
    if img.color_type == 0:
        return _gray8(img)
    rgba, has_alpha = _rgba(img)
    return rgba[..., [2, 1, 0, 3]] if has_alpha else rgba[..., [2, 1, 0]]


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as fh:
            return fh.read()
    except OSError as exc:
        raise PngError(f"cannot read {path}: {exc}") from None


def read_rgba(path: str) -> Tuple[np.ndarray, bool]:
    """``decode_rgba`` of a file; raises ``PngError`` for a file this
    reader does not take (missing, not a PNG, refused, corrupt)."""
    return decode_rgba(_read(path))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for a PNG; raises
    ``PngError`` (naming the format when the file is not a PNG) where
    cv2 would return None or the reader refuses the file."""
    data = _read(path)
    if data[:8] != SIGNATURE:
        kind = ("JPEG" if data[:2] == b"\xff\xd8" else
                "an unknown format")
        raise PngError(f"{path} is {kind}, not a PNG: only PNG inputs are "
                       "read")
    return decode_cv2(data)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """All five filters of every row of ``raw`` uint8 [H, rowbytes]:
    uint8 [5, H, rowbytes] (None, Sub, Up, Average, Paeth), from the raw
    bytes (uint8 differences wrap mod 256, as the format's do)."""
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    average = ((left.astype(np.uint16) + up) >> 1).astype(np.uint8)
    paeth = _paeth(*(x.astype(np.int16) for x in (left, up, upleft)))
    return np.stack([raw, raw - left, raw - up, raw - average,
                     raw - paeth.astype(np.uint8)])


# |byte| read as a signed char.
_SIGNED_MAGNITUDE = np.minimum(np.arange(256), 256 - np.arange(256)).astype(
    np.uint8)


def choose_filters(filtered: np.ndarray) -> np.ndarray:
    """libpng's heuristic: per row, the filter whose bytes, read as signed,
    have the smallest sum of magnitudes (the first such): int [H]."""
    cost = _SIGNED_MAGNITUDE[filtered].sum(-1, dtype=np.int64)   # [5, H]
    return np.argmin(cost, axis=0)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode(img: np.ndarray, filter_type: Optional[int] = None) -> bytes:
    """uint8 [H, W] gray or [H, W, C] with C = 2 (gray, alpha), 3 (RGB) or
    4 (RGBA) -> PNG bytes at 8 bits, not interlaced. Every row takes
    ``filter_type`` (0-4) if given, else libpng's heuristic's choice."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode: uint8 expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode: {c} channels")
    raw = np.ascontiguousarray(img).reshape(h, w * c)
    filtered = filter_rows(raw, c)
    if filter_type is None:
        types = choose_filters(filtered)
    else:
        if filter_type not in range(5):
            raise ValueError(f"encode: filter {filter_type}")
        types = np.full(h, filter_type)
    rows = filtered[types, np.arange(h)]
    body = np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray,
          filter_type: Optional[int] = None) -> int:
    """``encode`` to a file; returns the bytes written."""
    data = encode(img, filter_type)
    with open(path, "wb") as fh:
        fh.write(data)
    return len(data)

