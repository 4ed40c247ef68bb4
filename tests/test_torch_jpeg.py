"""The port's baseline JPEG decoder (lgm_tpu_torch/io/jpeg.py over
data/csrc/jpeg_decode.cpp, built here with the host compiler) against
``cv2.imread(IMREAD_UNCHANGED)`` (cv2's bundled libjpeg-turbo) and against
lgm_tpu's native decode (``lgm_tpu.native.decode_rgba``, the host's
libjpeg): the same pixels bit for bit on files cv2 writes at every
quality, sampling factor, restart interval and size listed, gray and
optimised-Huffman files and the colour-space markers; every refused class
raises ``JpegError``; the committed fixtures' manifest holds cv2's
digests; ``io/image.py`` dispatches PNG and JPEG by their magic bytes."""

import hashlib
import importlib.util
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import cv2

from lgm_tpu import native
from lgm_tpu_torch.io import ImageError, image, jpeg, png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")


def _load_fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", os.path.join(ROOT, "scripts",
                                           "make_jpeg_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fx = _load_fixture_script()
SAMPLINGS = sorted(fx.SAMPLING)


def _cv2(data: bytes) -> np.ndarray:
    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert arr is not None
    return arr


def _native_available() -> bool:
    """lgm_tpu builds its native decode at first use; another test worker
    may be writing the library at that moment, so try again a few
    times."""
    for _ in range(40):
        if native.dataload_available():
            return True
        native._dl_failed = False
        time.sleep(0.5)
    return False


def _native_rgba(data: bytes, tmp_path) -> np.ndarray:
    """lgm_tpu's native decode (float32 p / 255) read back as uint8."""
    assert _native_available(), "lgm_tpu's native decode does not build"
    path = str(tmp_path / "native.jpg")
    with open(path, "wb") as fh:
        fh.write(data)
    out = native.decode_rgba(path)
    assert out is not None
    return np.rint(out * 255).astype(np.uint8)


def _check(data: bytes, tmp_path=None):
    """The decode equals cv2's (both views) and, given ``tmp_path``,
    lgm_tpu's native one, bit for bit."""
    ref = _cv2(data)
    got = jpeg.decode_cv2(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    rgba, has_alpha = jpeg.decode_rgba(data)
    assert not has_alpha and (rgba[..., 3] == 255).all()
    rgb = np.repeat(ref[..., None], 3, -1) if ref.ndim == 2 else ref[..., ::-1]
    np.testing.assert_array_equal(rgba[..., :3], rgb)
    if tmp_path is not None:
        np.testing.assert_array_equal(rgba, _native_rgba(data, tmp_path))


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("quality", [5, 50, 75, 95, 100])
def test_quality_and_sampling(quality, sampling, tmp_path):
    _check(fx.encode(fx.pattern(37, 53, quality), quality, sampling),
           tmp_path)


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (33, 47), (255, 257)])
def test_sizes(hw, sampling, tmp_path):
    """Sizes that are not a multiple of the MCU, down to one pixel (h2v1
    and h2v2 box-upsample where the chroma is at most 2 wide)."""
    _check(fx.encode(fx.pattern(*hw), 75, sampling), tmp_path)


@pytest.mark.parametrize("quality", [5, 75, 100])
def test_gray(quality, tmp_path):
    data = fx.encode(fx.pattern(29, 41)[..., 1], quality)
    assert jpeg.decode_cv2(data).ndim == 2
    _check(data, tmp_path)


@pytest.mark.parametrize("sampling", ["444", "420", "411"])
@pytest.mark.parametrize("interval", [1, 2, 7])
def test_restart_intervals(interval, sampling, tmp_path):
    data = fx.encode(fx.pattern(45, 61), 75, sampling, rst=interval)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _check(data, tmp_path)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_optimized_huffman(sampling, tmp_path):
    _check(fx.encode(fx.pattern(37, 53), 90, sampling, optimize=True),
           tmp_path)


@pytest.mark.parametrize("edit", ["adobe_rgb", "rgb_ids", "dqt16"])
def test_colour_space_markers_and_16bit_tables(edit):
    """An Adobe APP14 with transform 0 and component ids 'R' 'G' 'B' make
    the samples RGB (no YCbCr conversion), as libjpeg's
    default_decompress_parms decides; 16-bit DQT reads as the 8-bit one."""
    base = fx.encode(fx.pattern(33, 47), 75)
    data = getattr(fx, edit)(base)
    _check(data)
    same = edit == "dqt16"
    assert np.array_equal(jpeg.decode(data), jpeg.decode(base)) == same


def test_exif_orientation_not_applied():
    """An APP1/EXIF block with orientation 6 is skipped: IMREAD_UNCHANGED
    does not rotate either."""
    base = fx.encode(fx.pattern(21, 34), 75)
    tiff = (b"MM\x00\x2a\x00\x00\x00\x08\x00\x01"
            b"\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06\x00\x00"
            b"\x00\x00\x00\x00")
    body = b"Exif\x00\x00" + tiff
    data = base[:2] + b"\xff\xe1" + len(body + b"..").to_bytes(2, "big") \
        + body + base[2:]
    assert jpeg.decode_cv2(data).shape == (21, 34, 3)
    _check(data)


def _refused():
    img = fx.pattern(33, 47)
    base = fx.encode(img, 75)
    cases = fx.refused(base, fx.encode(img, 75, progressive=True))
    for s in SAMPLINGS:
        cases[f"progressive_{s}"] = fx.encode(img, 90, s, progressive=True)
    cases["progressive_gray"] = fx.encode(img[..., 0], 75,
                                          progressive=True)
    for cut in (0.1, 0.5, 0.95):
        _, e = fx.find(base, 0xDA)
        cases[f"truncated_{cut}"] = base[:e + int((len(base) - e) * cut)]
    cases["no_eoi"] = base[:-2]
    cases["header_only"] = base[:fx.find(base, 0xDA)[0]]
    rst = fx.encode(img, 75, rst=2)
    cases["rst_out_of_order"] = rst.replace(b"\xff\xd1", b"\xff\xd3", 1)
    cases["rst_missing"] = rst.replace(b"\xff\xd1", b"", 1)
    return cases


REFUSED = _refused()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused(case):
    """Each class the decoder does not read raises ``JpegError`` (an
    ``ImageError``) and returns no pixels."""
    data = REFUSED[case]
    with pytest.raises(jpeg.JpegError):
        jpeg.decode(data)
    with pytest.raises(ImageError):
        image.decode_cv2(data, "upload.jpg")


@pytest.mark.parametrize("seed", range(4))
def test_mutated_files_decode_or_raise(seed):
    """Random byte edits, cuts and insertions of valid files (each
    sampling, with and without restarts, gray) decode or raise
    ``JpegError``: the decoder reads outside data without crashing."""
    rng = np.random.default_rng(seed)
    bases = [fx.encode(fx.pattern(33, 47), 75, s, rst=r)
             for s in SAMPLINGS for r in (0, 2)]
    bases.append(fx.encode(fx.pattern(20, 30)[..., 0], 60))
    for it in range(300):
        data = bytearray(bases[it % len(bases)])
        for _ in range(rng.integers(1, 6)):
            p = rng.integers(0, len(data))
            mode = rng.integers(0, 3)
            if mode == 0:
                data[p] = rng.integers(0, 256)
            elif mode == 1:
                data = data[:p] + data[p + rng.integers(1, 8):]
            else:
                data = data[:p] + rng.integers(
                    0, 256, rng.integers(1, 8)).astype(np.uint8).tobytes() \
                    + data[p:]
        try:
            out = jpeg.decode(bytes(data))
        except jpeg.JpegError:
            continue
        assert out.dtype == np.uint8 and out.size > 0


def _manifest():
    with open(os.path.join(FIXTURES, "MANIFEST.json")) as fh:
        return json.load(fh)


MANIFEST = _manifest()


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(MANIFEST["taken"]))
def test_fixture_manifest_is_cv2s(name):
    """The committed digests are cv2's decode of each fixture, and the
    port's decode has them."""
    path = os.path.join(FIXTURES, name)
    entry = MANIFEST["taken"][name]
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert _digest(ref) == entry["sha256"]
    assert list(ref.shape) == entry["shape"]
    got = jpeg.imread(path)
    assert _digest(got) == entry["sha256"]


@pytest.mark.parametrize("name", sorted(MANIFEST["refused"]))
def test_refused_fixtures(name):
    with pytest.raises(jpeg.JpegError):
        jpeg.imread(os.path.join(FIXTURES, name))


def test_fixture_files_are_the_scripts():
    """The committed small fixtures are what the script writes now (the
    rendered views are left out: the renderer is not under test here)."""
    taken = {"s420": fx.encode(fx.pattern(33, 47), 75),
             "gray": fx.encode(fx.pattern(33, 47)[..., 1], 75)}
    for name, data in taken.items():
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as fh:
            assert fh.read() == data


def test_threads_decode_alike():
    """Decoder calls release the GIL and share no state: eight threads
    decode eight files as one thread does."""
    datas = [fx.encode(fx.pattern(64 + i, 80, i), 60 + i, SAMPLINGS[i % 5])
             for i in range(8)]
    serial = [jpeg.decode(d) for d in datas]
    with ThreadPoolExecutor(8) as pool:
        parallel = list(pool.map(jpeg.decode, datas))
    for a, b in zip(serial, parallel):
        np.testing.assert_array_equal(a, b)


def test_image_dispatch(tmp_path):
    """``io/image.py`` sends PNG and JPEG to their readers by the magic
    bytes, whatever the file's name; another format, a missing file and a
    refused file raise ``ImageError`` naming the file."""
    assert issubclass(png.PngError, ImageError)
    assert issubclass(jpeg.JpegError, ImageError)
    img = fx.pattern(19, 23)
    jpg = tmp_path / "a.png"   # JPEG bytes under a .png name
    jpg.write_bytes(fx.encode(img, 80))
    pngf = tmp_path / "b.jpg"  # PNG bytes under a .jpg name
    pngf.write_bytes(png.encode(img[..., ::-1]))
    np.testing.assert_array_equal(image.imread(str(jpg)),
                                  cv2.imread(str(jpg), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(image.imread(str(pngf)), img)
    rgba, alpha = image.read_rgba(str(pngf))
    assert not alpha and np.array_equal(rgba[..., :3], img[..., ::-1])
    other = tmp_path / "c.gif"
    other.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ImageError, match="c.gif is an unknown format"):
        image.imread(str(other))
    with pytest.raises(ImageError, match="missing.jpg"):
        image.read_rgba(str(tmp_path / "missing.jpg"))
    bad = tmp_path / "d.jpg"
    bad.write_bytes(REFUSED["progressive"])
    with pytest.raises(jpeg.JpegError, match="d.jpg: progressive"):
        image.read_rgba(str(bad))
