"""ctypes bindings of the port's native mesh operations
(``csrc/meshops.cpp``).

Port of the ``meshops`` half of ``lgm_tpu/native.py``: marching
tetrahedra, vertex-clustering decimation, weld and clean, and the
chart-based UV unwrap, with the same argument types and retry caps. The
C++ source is the port's own copy of ``native/meshops.cpp``; it is built
at first use by ``ops/_build.py::build_host`` into ``build/host/``, and a
failed build raises (nothing falls back). The ``dataload`` half is
covered by ``data/decode.py``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from lgm_tpu_torch.ops import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "meshops.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load the mesh operations."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build_host(_SRC)))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        ip = ctypes.POINTER(ctypes.c_int)
        lib.lgm_marching_tetrahedra.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            f32p, ctypes.c_int, i32p, ctypes.c_int, ip, ip,
        ]
        lib.lgm_decimate_cluster.argtypes = [
            f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_float,
            f32p, i32p, ip, ip,
        ]
        lib.lgm_weld_and_clean.argtypes = [
            f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_float,
            f32p, i32p, ip, ip,
        ]
        lib.lgm_chart_unwrap.argtypes = [
            f32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, f32p, ctypes.c_int, f32p, i32p, ip, ip,
        ]
        _lib = lib
        return lib


def marching_cubes(grid: np.ndarray, iso: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a [nx, ny, nz] density grid at level ``iso``.
    Returns (verts [V, 3] in grid-index coordinates, faces [F, 3] int32).
    Implemented as marching tetrahedra (see csrc/meshops.cpp)."""
    lib = load_library()
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    cap_v, cap_f = 1 << 20, 1 << 21
    for _ in range(4):
        verts = np.empty((cap_v, 3), np.float32)
        faces = np.empty((cap_f, 3), np.int32)
        nv = ctypes.c_int()
        nf = ctypes.c_int()
        rc = lib.lgm_marching_tetrahedra(
            grid, nx, ny, nz, float(iso), verts, cap_v, faces, cap_f,
            ctypes.byref(nv), ctypes.byref(nf),
        )
        if rc == 0:
            return verts[: nv.value].copy(), faces[: nf.value].copy()
        cap_v = max(cap_v * 2, nv.value + 1)
        cap_f = max(cap_f * 2, nf.value + 1)
    raise RuntimeError("marching tetrahedra output exceeded retry caps")


def decimate(verts: np.ndarray, faces: np.ndarray, cell: float
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-grid vertex-clustering decimation (cell in mesh units)."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    lib.lgm_decimate_cluster(
        verts, len(verts), faces, len(faces), float(cell), out_v, out_f,
        ctypes.byref(nv), ctypes.byref(nf),
    )
    v, f = out_v[: nv.value].copy(), out_f[: nf.value].copy()
    return clean(v, f, eps=0.0)[0:2]


def decimate_to_target(verts: np.ndarray, faces: np.ndarray,
                       target_faces: int, iters: int = 8
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Binary-search the clustering cell size for ~target face count
    (the reference targets 5e4 faces, convert.py:296)."""
    if len(faces) <= target_faces:
        return verts, faces
    ext = verts.max(0) - verts.min(0)
    lo, hi = 1e-4 * ext.max(), 0.3 * ext.max()
    best = (verts, faces)
    for _ in range(iters):
        cell = float(np.sqrt(lo * hi))
        v, f = decimate(verts, faces, cell)
        if len(f) > target_faces:
            lo = cell
            best = (v, f)
        else:
            hi = cell
            best = (v, f)
            if len(f) > 0.5 * target_faces:
                break
    return best


def clean(verts: np.ndarray, faces: np.ndarray, eps: float = 1e-5
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Weld near-duplicate vertices, drop degenerate faces and
    unreferenced vertices (kiui clean_mesh equivalent)."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    lib.lgm_weld_and_clean(
        verts, len(verts), faces, len(faces), float(eps), out_v, out_f,
        ctypes.byref(nv), ctypes.byref(nf),
    )
    return out_v[: nv.value].copy(), out_f[: nf.value].copy()


def chart_unwrap(verts: np.ndarray, faces: np.ndarray,
                 cos_thresh: float = 0.5, margin: float = 0.01
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Chart-based UV atlas (xatlas-class replacement, ref:
    convert.py:370-372): normal-coherent chart growing + per-chart plane
    projection + shelf packing at uniform texel density. Returns
    (verts' [V', 3] with chart-boundary duplication, uv [V', 2] in
    [0, 1]^2, faces [F, 3], n_charts). ``cos_thresh`` bounds a chart's
    normal spread (0.5 = 60 deg from the chart mean), which bounds the
    plane-projection stretch to 1/cos_thresh."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    max_v = 3 * len(faces) + 8
    out_v = np.empty((max_v, 3), np.float32)
    out_uv = np.empty((max_v, 2), np.float32)
    out_f = np.empty_like(faces)
    nv = ctypes.c_int()
    nc = ctypes.c_int()
    rc = lib.lgm_chart_unwrap(
        verts, len(verts), faces, len(faces), float(cos_thresh),
        float(margin), out_v, max_v, out_uv, out_f,
        ctypes.byref(nv), ctypes.byref(nc),
    )
    if rc != 0:
        raise RuntimeError(f"chart_unwrap overflow: needs {nv.value} verts")
    return (out_v[: nv.value].copy(), out_uv[: nv.value].copy(),
            out_f.copy(), nc.value)
