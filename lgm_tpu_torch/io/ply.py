"""PLY import/export of packed Gaussians, 3DGS-ecosystem compatible.

The package's own copy of ``lgm_tpu/io/ply.py`` (numpy only).

Behavior parity with the reference (ref: core/gs.py:101-190): pruning by
opacity >= 0.005, activation inversion to the standard 3DGS storage format
(inverse-sigmoid opacity, log scales, SH DC coefficients
(rgb - 0.5) / 0.28209479177387814) on save, and re-activation on load.
Written against the raw binary_little_endian PLY format directly (the
`plyfile` package is not available in this environment).

Property order matches the reference exactly:
x, y, z, f_dc_0..2, opacity, scale_0..2, rot_0..3 (no normals — same as
the ashawkey fork's writer).
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

SH_C0 = 0.28209479177387814
OPACITY_PRUNE = 0.005

_PROPS = (
    ["x", "y", "z"]
    + [f"f_dc_{i}" for i in range(3)]
    + ["opacity"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
)


def _inverse_sigmoid(x):
    x = np.clip(x, 1e-7, 1 - 1e-7)
    return np.log(x / (1 - x))


def save_ply(gaussians: np.ndarray, path: str, compatible: bool = True):
    """Write [N, 14] activated Gaussians (pos|opacity|scale|quat|rgb).

    ``compatible=True`` stores pre-activation values as the original 3DGS
    tooling expects (ref: core/gs.py:122-127)."""
    g = np.asarray(gaussians, np.float32)
    if g.ndim == 3:
        assert g.shape[0] == 1, "only batch size 1 supported"
        g = g[0]
    mask = g[:, 3] >= OPACITY_PRUNE
    g = g[mask]

    pos = g[:, 0:3]
    opacity = g[:, 3:4]
    scale = g[:, 4:7]
    rot = g[:, 7:11]
    rgb = g[:, 11:14]

    if compatible:
        opacity = _inverse_sigmoid(opacity)
        scale = np.log(scale + 1e-8)
        rgb = (rgb - 0.5) / SH_C0

    data = np.concatenate([pos, rgb, opacity, scale, rot], axis=1).astype(
        "<f4"
    )
    rec = np.rec.fromarrays(
        data.T, dtype=[(p, "<f4") for p in _PROPS]
    )
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(rec)}\n"
        + "".join(f"property float {p}\n" for p in _PROPS)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def _parse_header(f) -> tuple:
    """Returns (num_vertices, [(name, np_dtype)], fmt) for 'vertex'."""
    line = f.readline().decode("ascii").strip()
    assert line == "ply", f"not a PLY file: {line!r}"
    fmt = None
    props = []
    n_vert = 0
    in_vertex = False
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8",
        "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
    }
    while True:
        line = f.readline().decode("ascii").strip()
        if line == "end_header":
            break
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n_vert = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            props.append((parts[2], type_map[parts[1]]))
    assert fmt == "binary_little_endian", f"unsupported format {fmt}"
    return n_vert, props


def load_ply(path: Union[str, bytes, io.IOBase],
             compatible: bool = True) -> np.ndarray:
    """Read a 3DGS PLY into packed [N, 14] Gaussians, re-activating stored
    values when ``compatible`` (ref: core/gs.py:154-190). Extra properties
    (normals, higher-order SH) are ignored; missing colors default to DC=0."""
    close = False
    if isinstance(path, (str, bytes)):
        f = open(path, "rb")
        close = True
    else:
        f = path
    try:
        n, props = _parse_header(f)
        rec = np.frombuffer(
            f.read(n * np.dtype(props).itemsize), dtype=np.dtype(props),
            count=n,
        )
    finally:
        if close:
            f.close()

    names = {p[0] for p in props}

    def col(name, default=0.0):
        if name in names:
            return np.asarray(rec[name], np.float32)
        return np.full(n, default, np.float32)

    g = np.zeros((n, 14), np.float32)
    g[:, 0] = col("x")
    g[:, 1] = col("y")
    g[:, 2] = col("z")
    g[:, 3] = col("opacity")
    for i in range(3):
        g[:, 4 + i] = col(f"scale_{i}")
    for i in range(4):
        g[:, 7 + i] = col(f"rot_{i}", 1.0 if i == 0 else 0.0)
    for i in range(3):
        g[:, 11 + i] = col(f"f_dc_{i}")

    if compatible:
        g[:, 3] = 1.0 / (1.0 + np.exp(-g[:, 3]))
        g[:, 4:7] = np.exp(g[:, 4:7])
        g[:, 11:14] = SH_C0 * g[:, 11:14] + 0.5
    return g
