"""Mesh export: binary glTF 2.0 (.glb) with an embedded PNG texture, and
.obj.

Port of ``lgm_tpu/io/mesh.py``: the same writers, chunk layout, 4-byte
padding and v-flip of the UVs. The texture is quantised as lgm_tpu does,
``(clip(t, 0, 1) * 255).astype(uint8)`` (truncation), and encoded by the
port's own PNG writer (``io/png.py``) instead of ``cv2``, which the card
host lacks: the bytes differ from lgm_tpu's, the decoded pixels do not.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np

from lgm_tpu_torch.io import png


def _quantise(image01: np.ndarray) -> np.ndarray:
    return (np.clip(image01, 0, 1) * 255).astype(np.uint8)


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((-len(b)) % 4)


def export_glb(path: str, verts: np.ndarray, faces: np.ndarray,
               uv: Optional[np.ndarray] = None,
               texture: Optional[np.ndarray] = None):
    """verts [V, 3] f32, faces [F, 3] int, uv [V, 2] in [0, 1] (glTF's
    v-down convention handled here), texture [H, W, 3] RGB in [0, 1]."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.uint32)

    buffers = []
    views = []
    accessors = []

    def add_blob(data: bytes, target=None):
        offset = sum(len(b) for b in buffers)
        buffers.append(_pad4(data))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            view["target"] = target
        views.append(view)
        return len(views) - 1

    def add_accessor(view, ctype, dtype, count, vmin=None, vmax=None):
        acc = {"bufferView": view, "componentType": dtype, "count": count,
               "type": ctype}
        if vmin is not None:
            acc["min"] = vmin
            acc["max"] = vmax
        accessors.append(acc)
        return len(accessors) - 1

    pos_view = add_blob(verts.tobytes(), target=34962)
    pos_acc = add_accessor(
        pos_view, "VEC3", 5126, len(verts),
        verts.min(0).tolist(), verts.max(0).tolist(),
    )
    idx_view = add_blob(faces.reshape(-1).tobytes(), target=34963)
    idx_acc = add_accessor(idx_view, "SCALAR", 5125, faces.size)

    attributes = {"POSITION": pos_acc}
    material = {"pbrMetallicRoughness": {"metallicFactor": 0.0,
                                         "roughnessFactor": 1.0}}
    images = []
    textures = []
    samplers = []
    if uv is not None and texture is not None:
        uv_gl = np.asarray(uv, np.float32).copy()
        uv_gl[:, 1] = 1.0 - uv_gl[:, 1]  # our v-up -> glTF v-down
        uv_view = add_blob(uv_gl.tobytes(), target=34962)
        uv_acc = add_accessor(uv_view, "VEC2", 5126, len(uv_gl))
        attributes["TEXCOORD_0"] = uv_acc
        img_view = add_blob(png.encode(_quantise(texture)))
        images.append({"bufferView": img_view, "mimeType": "image/png"})
        samplers.append({"magFilter": 9729, "minFilter": 9729})
        textures.append({"sampler": 0, "source": 0})
        material["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}

    gltf = {
        "asset": {"version": "2.0", "generator": "lgm_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{
            "primitives": [{
                "attributes": attributes,
                "indices": idx_acc,
                "material": 0,
            }]
        }],
        "materials": [material],
        "bufferViews": views,
        "accessors": accessors,
    }
    if images:
        gltf["images"] = images
        gltf["textures"] = textures
        gltf["samplers"] = samplers

    bin_chunk = b"".join(buffers)
    gltf["buffers"] = [{"byteLength": len(bin_chunk)}]

    json_chunk = _pad4(json.dumps(gltf).encode("utf-8"), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)


def load_glb(path: str):
    """Minimal GLB reader: returns (verts, faces, uv or None,
    texture_png_bytes or None)."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        jlen, jtype = struct.unpack("<II", f.read(8))
        assert jtype == 0x4E4F534A
        gltf = json.loads(f.read(jlen))
        blen, btype = struct.unpack("<II", f.read(8))
        assert btype == 0x004E4942
        blob = f.read(blen)

    def read_acc(idx, dtype, ncomp):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        start = view.get("byteOffset", 0)
        data = blob[start:start + view["byteLength"]]
        return np.frombuffer(data, dtype=dtype).reshape(-1, ncomp)

    prim = gltf["meshes"][0]["primitives"][0]
    verts = read_acc(prim["attributes"]["POSITION"], np.float32, 3)
    faces = read_acc(prim["indices"], np.uint32, 3)
    uv = None
    if "TEXCOORD_0" in prim["attributes"]:
        uv = read_acc(prim["attributes"]["TEXCOORD_0"], np.float32, 2)
    tex = None
    if gltf.get("images"):
        view = gltf["bufferViews"][gltf["images"][0]["bufferView"]]
        start = view.get("byteOffset", 0)
        tex = blob[start:start + view["byteLength"]]
    return verts, faces, uv, tex


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray,
               uv: Optional[np.ndarray] = None,
               texture: Optional[np.ndarray] = None):
    """Wavefront .obj; with a texture also ``<stem>.png`` and
    ``<stem>.mtl`` beside it."""
    stem = path.rsplit(".", 1)[0]
    name = os.path.basename(stem)
    lines = []
    if uv is not None and texture is not None:
        png.write(stem + ".png", _quantise(texture))
        with open(stem + ".mtl", "w") as f:
            f.write(f"newmtl mat0\nmap_Kd {name}.png\n")
        lines.append(f"mtllib {name}.mtl")
    for v in verts:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    if uv is not None:
        for t in uv:
            lines.append(f"vt {t[0]:.6f} {t[1]:.6f}")
        lines.append("usemtl mat0")
        for f3 in faces + 1:
            lines.append(
                f"f {f3[0]}/{f3[0]} {f3[1]}/{f3[1]} {f3[2]}/{f3[2]}"
            )
    else:
        for f3 in faces + 1:
            lines.append(f"f {f3[0]} {f3[1]} {f3[2]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
