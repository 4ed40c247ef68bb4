"""The port's PNG reader and writer (lgm_tpu_torch/io/png.py) against
cv2.imread (libpng underneath), PIL's files and lgm_tpu's native decode
(libpng's simplified API): the same pixels bit for bit on every file the
reader takes, the C++ unfilter equal to the plain one, the writer's files
read back by cv2, and the files it refuses."""

import struct
import zlib

import numpy as np
import pytest

import cv2
from PIL import Image

from lgm_tpu import native
from lgm_tpu_torch.io import png
from lgm_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _image(h=37, w=53, seed=0):
    """uint8 RGBA with smooth gradients (so the filters differ) and a
    band of noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 5) % 256, (y * 7) % 256, (x * y) % 256,
                    rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
    img[5:10] = rng.integers(0, 256, (5, w, 4))
    return img


def _with_chunk(data: bytes, ctype: bytes, body: bytes) -> bytes:
    """PNG bytes with one more chunk right after IHDR."""
    chunk = (struct.pack(">I", len(body)) + ctype + body
             + struct.pack(">I", zlib.crc32(ctype + body)))
    return data[:33] + chunk + data[33:]


def _write_pil(path, img, mode, **kw):
    Image.fromarray(img, mode).save(path, **kw)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> path of PNGs written by cv2 (libpng's adaptive filters) and
    PIL at every colour type the reader takes."""
    d = tmp_path_factory.mktemp("png")
    img = _image()
    out = {}

    def add(name, write):
        path = str(d / f"{name}.png")
        write(path)
        out[name] = path

    add("cv2_bgra", lambda p: cv2.imwrite(p, img))
    add("cv2_bgr", lambda p: cv2.imwrite(p, img[..., :3]))
    add("cv2_gray", lambda p: cv2.imwrite(p, img[..., 0]))
    add("pil_la", lambda p: _write_pil(p, img[..., :2], "LA"))
    add("pil_rgba", lambda p: _write_pil(p, img, "RGBA"))
    add("pil_rgb_trns", lambda p: _write_pil(p, img[..., :3], "RGB",
                                             transparency=(0, 0, 0)))
    add("pil_gray_trns", lambda p: _write_pil(p, img[..., 0], "L",
                                              transparency=37))
    rgb = Image.fromarray(img[..., :3], "RGB")
    add("pil_palette", lambda p: rgb.quantize(200).save(p))
    add("pil_palette_trns", lambda p: rgb.quantize(200).save(
        p, transparency=bytes(range(0, 200, 2))))
    add("pil_palette_4bit", lambda p: rgb.quantize(12).save(p))
    add("pil_palette_2bit", lambda p: rgb.quantize(3).save(p))
    add("pil_gray_1bit", lambda p: Image.fromarray(img[..., 0] > 128).save(p))
    return out


def _native_rgba(path):
    """lgm_tpu's libpng decode as uint8 RGBA (alpha 255 without one)."""
    return np.round(native.decode_rgba(path) * 255).astype(np.uint8)


@pytest.mark.parametrize("name", [
    "cv2_bgra", "cv2_bgr", "cv2_gray", "pil_la", "pil_rgba", "pil_rgb_trns",
    "pil_gray_trns", "pil_palette", "pil_palette_trns", "pil_palette_4bit",
    "pil_palette_2bit", "pil_gray_1bit"])
def test_reader_matches_cv2_and_libpng(files, name):
    """imread == cv2.imread(IMREAD_UNCHANGED) (shape and every byte);
    read_rgba == libpng's simplified API (lgm_tpu's native decode)."""
    path = files[name]
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ours = png.imread(path)
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    rgba, has_alpha = png.read_rgba(path)
    np.testing.assert_array_equal(rgba, _native_rgba(path))
    assert has_alpha == (name in ("cv2_bgra", "pil_la", "pil_rgba")
                         or name.endswith("trns"))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_writer_roundtrip_through_cv2(tmp_path, filter_type, channels):
    """Every filter (and the adaptive choice), every colour type: cv2 reads
    the writer's file back unchanged, and so does the port's reader with
    the C++ unfilter and with the plain one."""
    img = _image(h=29, w=41, seed=channels)[..., :channels]
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "x.png")
    png.write(path, img, filter_type)
    order = {1: [], 2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[channels]
    expect = img[..., order] if order else img
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  expect)
    np.testing.assert_array_equal(png.imread(path), expect)
    data = open(path, "rb").read()
    np.testing.assert_array_equal(
        png.decode_cv2(data, unfilter_fn=png.unfilter_plain), expect)


def test_adaptive_filter_uses_several_filters_and_the_heuristic():
    """The writer's choice is libpng's rule (least sum of |signed byte|,
    first on ties), and this image exercises more than one filter."""
    raw = _image().reshape(37, -1)
    filtered = png.filter_rows(raw, 4)
    signed = filtered.astype(np.int8).astype(np.int64)
    cost = np.abs(signed).sum(-1)
    np.testing.assert_array_equal(png.choose_filters(filtered),
                                  np.argmin(cost, axis=0))
    assert len(set(png.choose_filters(filtered).tolist())) >= 3
    data = png.encode(_image())
    # Each stored row begins with the filter it took.
    body = zlib.decompress(data[33 + 8:-12 - 4])
    rows = np.frombuffer(body, np.uint8).reshape(37, 1 + 53 * 4)
    np.testing.assert_array_equal(rows[:, 0], png.choose_filters(filtered))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_cpp_unfilter_equals_plain(bpp):
    """The C++ loop and numpy's on random filtered rows with every filter
    type at every pixel width: the same bytes."""
    rng = np.random.default_rng(bpp)
    h, rowbytes = 23, 31 * bpp
    data = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    data[:, 0] = np.arange(h) % 5
    np.testing.assert_array_equal(png.unfilter(data, h, rowbytes, bpp),
                                  png.unfilter_plain(data, h, rowbytes, bpp))
    data[3, 0] = 5
    with pytest.raises(png.PngError, match="filter"):
        png.unfilter(data, h, rowbytes, bpp)


def test_corrupt_truncated_missing_and_other_formats(tmp_path, files):
    """Unreadable files raise PngError from the reader; a non-PNG names
    its format."""
    good = open(files["cv2_bgra"], "rb").read()
    cases = {
        "truncated": good[:len(good) // 2],
        "no_iend": good[:-12],
        "bad_crc": good[:40] + bytes([good[40] ^ 1]) + good[41:],
        "garbage": b"\x89PNGgarbage",
        "empty": b"",
    }
    for name, data in cases.items():
        path = str(tmp_path / f"{name}.png")
        open(path, "wb").write(data)
        with pytest.raises(png.PngError):
            png.read_rgba(path)
        assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None or \
            name == "no_iend"
    with pytest.raises(png.PngError):
        png.read_rgba(str(tmp_path / "missing.png"))
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, _image()[..., :3])
    with pytest.raises(png.PngError, match="JPEG, not a PNG"):
        png.imread(jpg)


def test_refused_16bit_interlaced_gamma_and_iccp(tmp_path):
    """What the reader refuses, and why: libpng's simplified API (lgm_tpu's
    decode) and cv2 give different pixels for 16-bit files and for a
    gAMA far from sRGB's; a gAMA near 1/2.2 is taken, and both decoders
    give the raw bytes there."""
    img = _image(h=16, w=16)[..., :3]
    data = png.encode(img)

    path16 = str(tmp_path / "deep.png")
    cv2.imwrite(path16, img.astype(np.uint16) * 257)
    cv16 = cv2.imread(path16, cv2.IMREAD_UNCHANGED)
    assert cv16.dtype == np.uint16
    assert not np.array_equal(_native_rgba(path16)[..., :3],
                              (cv16 >> 8)[..., ::-1].astype(np.uint8))
    with pytest.raises(png.PngError, match="16-bit"):
        png.read_rgba(path16)

    interlaced = bytearray(data)
    interlaced[28] = 1     # IHDR interlace method: Adam7
    interlaced[29:33] = struct.pack(">I", zlib.crc32(bytes(
        interlaced[12:29])))
    with pytest.raises(png.PngError, match="interlaced"):
        png.decode_rgba(bytes(interlaced))

    for gamma, taken in ((45455, True), (45000, True), (0, True),
                         (43000, False), (50000, False), (100000, False)):
        path = str(tmp_path / f"gamma{gamma}.png")
        open(path, "wb").write(_with_chunk(data, b"gAMA",
                                           struct.pack(">I", gamma)))
        raw = np.array_equal(_native_rgba(path)[..., :3], img)
        assert raw == taken, gamma      # libpng corrects the others
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img[..., ::-1])
        if taken:
            np.testing.assert_array_equal(png.read_rgba(path)[0][..., :3],
                                          img)
        else:
            with pytest.raises(png.PngError, match="gAMA"):
                png.read_rgba(path)
    iccp = _with_chunk(data, b"iCCP", b"icc\x00\x00" + zlib.compress(b"x"))
    with pytest.raises(png.PngError, match="iCCP"):
        png.decode_rgba(iccp)


def test_host_build_raises_on_failure(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="host build of broken.cpp"):
        _build.build_host(bad)
    assert not _build.host_target(bad).exists()
    good = _build.build_host(png._SRC)
    assert good.parent == tmp_path / "host"
    assert good.name.startswith("png_unfilter-") and good.suffix == ".so"
