"""Write the JPEG fixtures of ``tests/fixtures/jpeg/`` and their manifest.

Every file is encoded by ``cv2.imencode`` (libjpeg-turbo) from seeded
pixels; the manifest (``MANIFEST.json``) holds, for each file the port's
decoder takes, the SHA-256 and shape of ``cv2.imread(path,
IMREAD_UNCHANGED)``'s array, and for each file it refuses the class of the
refusal. ``tests/test_torch_jpeg.py`` checks the digests against ``cv2``
on a host that has it, and ``chip_smoke.py`` (phase ``jpeg_codec``) holds
the port's decodes on the card to them.

Files:
- ``s444`` ... ``s411``: 33 x 47 at quality 75 at each sampling factor;
  ``q5``, ``q100``: 4:2:0 at qualities 5 and 100; ``gray``, ``rst`` (a
  restart interval of 2 MCUs), ``optimized`` (optimised Huffman tables),
  ``px1`` (1 x 1), ``px7x13``, ``px255x257``;
- byte edits of a 4:2:0 file: ``adobe_rgb`` (JFIF replaced by an Adobe
  APP14 with transform 0: the samples are RGB), ``rgb_ids`` (no JFIF,
  component ids 'R' 'G' 'B'), ``dqt16`` (its tables as 16-bit DQT);
- ``view0``-``view3``: a seeded Gaussian scene rendered by the port at
  azimuths 0/90/180/270, 256² on white, 4:2:0 at quality 90 (the JPEG
  inputs of ``chip_smoke.py``'s ``infer_cli`` and ``app_http``);
  ``bench512``, ``bench1024``: the scene at 512² and 1024², 4:2:0 at
  quality 90 (decode times);
- ``refused/``: progressive, lossless, arithmetic (SOF9), 12-bit, CMYK (4
  components), DNL (height 0), non-interleaved (a 3-component frame with a
  1-component scan), missing Huffman and quantisation tables, a corrupt
  Huffman table, corrupt entropy-coded data and a truncated file.

Run (needs cv2): python scripts/make_jpeg_fixtures.py [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "jpeg")

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


def pattern(h: int, w: int, seed: int = 0) -> np.ndarray:
    """uint8 BGR [h, w, 3]: gradients (smooth blocks) with a band of noise
    (busy blocks, large coefficients)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 5) % 256, (y * 7) % 256, (x * y) % 256],
                   -1).astype(np.uint8)
    band = slice(h // 3, h // 3 + 5)
    img[band] = rng.integers(0, 256, img[band].shape)
    return img


def encode(img: np.ndarray, quality: int = 75, sampling: str = "420",
           rst: int = 0, optimize: bool = False,
           progressive: bool = False) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
        cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


# ---------------------------------------------------------------------------
# Byte edits of a file cv2 wrote (marker segments before the scan)
# ---------------------------------------------------------------------------


def segments(data: bytes):
    """(marker, start, end) of each marker segment from SOI up to and
    including SOS (``start`` at the FF, ``end`` past the segment)."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, pos, pos + 2 + length))
        if marker == 0xDA:
            return out
        pos += 2 + length


def find(data: bytes, marker: int):
    """(start, end) of the first segment with ``marker``."""
    for m, s, e in segments(data):
        if m == marker:
            return s, e
    raise KeyError(hex(marker))


def drop(data: bytes, marker: int) -> bytes:
    """``data`` without any segment of ``marker``."""
    cut = [(s, e) for m, s, e in segments(data) if m == marker]
    for s, e in reversed(cut):
        data = data[:s] + data[e:]
    return data


def set_sof(data: bytes, marker: int) -> bytes:
    s, _ = find(data, 0xC0)
    return data[:s + 1] + bytes([marker]) + data[s + 2:]


def sof_byte(data: bytes, offset: int, value: int) -> bytes:
    """Set byte ``offset`` of the SOF0 segment's body (0 = precision)."""
    s, _ = find(data, 0xC0)
    p = s + 4 + offset
    return data[:p] + bytes([value]) + data[p + 1:]


def four_components(data: bytes) -> bytes:
    """A fourth component (id 4, 1 x 1, table 0) in the frame header."""
    s, e = find(data, 0xC0)
    body = bytearray(data[s + 4:e])
    body[5] = 4
    body += bytes([4, 0x11, 0])
    seg = b"\xff\xc0" + struct.pack(">H", len(body) + 2) + bytes(body)
    return data[:s] + seg + data[e:]


def one_component_scan(data: bytes) -> bytes:
    """The scan header cut to its first component (a non-interleaved scan
    of a 3-component frame)."""
    s, e = find(data, 0xDA)
    body = data[s + 4:e]
    new = bytes([1]) + body[1:3] + body[-3:]
    return data[:s] + b"\xff\xda" + struct.pack(">H", len(new) + 2) + new \
        + data[e:]


def adobe_rgb(data: bytes) -> bytes:
    """JFIF's APP0 replaced by an Adobe APP14 with transform 0 (RGB)."""
    data = drop(data, 0xE0)
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    return data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) + body \
        + data[2:]


def rgb_ids(data: bytes) -> bytes:
    """No JFIF marker; components 1, 2, 3 renamed 'R', 'G', 'B' in the
    frame and scan headers."""
    data = bytearray(drop(data, 0xE0))
    s, _ = find(bytes(data), 0xC0)
    for i, cid in enumerate(b"RGB"):
        data[s + 4 + 6 + 3 * i] = cid
    s, _ = find(bytes(data), 0xDA)
    for i, cid in enumerate(b"RGB"):
        data[s + 4 + 1 + 2 * i] = cid
    return bytes(data)


def dqt16(data: bytes) -> bytes:
    """Every quantisation table rewritten at 16-bit precision (Pq 1), the
    same values."""
    out = bytearray()
    prev = 0
    for m, s, e in segments(data):
        if m != 0xDB:
            continue
        body, new, i = data[s + 4:e], bytearray(), 0
        while i < len(body):
            new.append(0x10 | (body[i] & 15))
            for v in body[i + 1:i + 65]:
                new += struct.pack(">H", v)
            i += 65
        out += data[prev:s] + b"\xff\xdb" + struct.pack(">H", len(new) + 2) \
            + new
        prev = e
    return bytes(out + data[prev:])


def bad_huffman_table(data: bytes) -> bytes:
    """Three codes of the first DHT's first length with three or more
    moved to length 1, the count kept: more codes than one bit holds."""
    s, _ = find(data, 0xC4)
    counts = bytearray(data[s + 5:s + 21])
    counts[next(i for i, c in enumerate(counts) if c >= 3)] -= 3
    counts[0] += 3
    return data[:s + 5] + bytes(counts) + data[s + 21:]


def corrupt_scan(data: bytes) -> bytes:
    """A marker (RST5, with no restart interval) written over the middle
    of the entropy-coded data."""
    _, e = find(data, 0xDA)
    p = e + (len(data) - 2 - e) // 2
    return data[:p] + b"\xff\xd5" + data[p + 2:]


def truncated(data: bytes) -> bytes:
    _, e = find(data, 0xDA)
    return data[:e + (len(data) - e) // 2]


def refused(base: bytes, progressive: bytes) -> dict:
    """Refusal class -> bytes the decoder must refuse."""
    return {
        "progressive": progressive,
        "lossless": set_sof(base, 0xC3),
        "arithmetic": set_sof(base, 0xC9),
        "12bit": sof_byte(base, 0, 12),
        "cmyk": four_components(base),
        "dnl": sof_byte(sof_byte(base, 1, 0), 2, 0),
        "non_interleaved": one_component_scan(base),
        "missing_huffman": drop(base, 0xC4),
        "missing_quant": drop(base, 0xDB),
        "bad_huffman_table": bad_huffman_table(base),
        "corrupt_scan": corrupt_scan(base),
        "truncated": truncated(base),
    }


# ---------------------------------------------------------------------------
# The files
# ---------------------------------------------------------------------------


def render(sizes, seed: int = 7):
    """The seeded scene (``sample_scene``, 4,096 splats) rendered by the
    port on the CPU over white at azimuths 0/90/180/270 (elevation 0,
    radius 1.5): {size: uint8 BGR [4, S, S, 3]}."""
    import torch

    sys.path.insert(0, ROOT)
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.ops.gsplat.api import render_views
    from lgm_tpu_torch.utils import camera

    g = torch.as_tensor(sample_scene(np.random.default_rng(seed), 4096))
    poses = np.stack([camera.orbit_camera(0.0, a, 1.5)
                      for a in (0.0, 90.0, 180.0, 270.0)])
    cams = camera.build_camera_inputs(poses, 49.1, 0.5, 2.5)
    tan = float(np.tan(0.5 * np.deg2rad(49.1)))
    out = {}
    with torch.inference_mode():
        for s in sizes:
            img = render_views(g[None], torch.as_tensor(
                cams["cam_view"])[None], s, tan,
                bg_color=torch.ones(1, 4, 3), with_depth=False,
                dup=32)["image"][0]
            rgb = (img.clamp(0, 1) * 255).to(torch.uint8).numpy()
            out[s] = np.ascontiguousarray(rgb[..., ::-1])
    return out


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def files() -> tuple:
    """({name: bytes} taken, {class: bytes} refused)."""
    img = pattern(33, 47)
    taken = {f"s{k}": encode(img, 75, k) for k in SAMPLING}
    taken["q5"] = encode(img, 5)
    taken["q100"] = encode(img, 100)
    taken["gray"] = encode(img[..., 1], 75)
    taken["rst"] = encode(img, 75, rst=2)
    taken["optimized"] = encode(img, 75, optimize=True)
    taken["px1"] = encode(pattern(1, 1), 75)
    taken["px7x13"] = encode(pattern(7, 13), 75)
    taken["px255x257"] = encode(pattern(255, 257), 75)
    base = taken["s420"]
    taken["adobe_rgb"] = adobe_rgb(base)
    taken["rgb_ids"] = rgb_ids(base)
    taken["dqt16"] = dqt16(base)
    views = render((256, 512, 1024))
    for i in range(4):
        taken[f"view{i}"] = encode(views[256][i], 90)
    taken["bench512"] = encode(views[512][0], 90)
    taken["bench1024"] = encode(views[1024][0], 90)
    return taken, refused(base, encode(img, 75, progressive=True))


def main(argv=None) -> int:
    import cv2

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    taken, bad = files()
    os.makedirs(os.path.join(args.out, "refused"), exist_ok=True)
    manifest = {"taken": {}, "refused": {}}
    for name, data in taken.items():
        arr = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        with open(os.path.join(args.out, f"{name}.jpg"), "wb") as fh:
            fh.write(data)
        manifest["taken"][f"{name}.jpg"] = {"sha256": digest(arr),
                                            "shape": list(arr.shape)}
    for name, data in bad.items():
        with open(os.path.join(args.out, "refused", f"{name}.jpg"),
                  "wb") as fh:
            fh.write(data)
        manifest["refused"][f"refused/{name}.jpg"] = name
    with open(os.path.join(args.out, "MANIFEST.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {len(taken)} files, {len(bad)} refused, to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
