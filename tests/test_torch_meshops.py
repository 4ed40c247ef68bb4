"""The port's native mesh operations (lgm_tpu_torch/native.py over its own
copy of meshops.cpp) against lgm_tpu.native's, bit for bit, on a sphere
SDF grid and tests/test_meshops.py's concave two-lobed shape."""

import numpy as np
import pytest

from lgm_tpu import native as jnative
from lgm_tpu_torch import native
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def sphere_grid(n=40, r=0.6):
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return (10.0 * (r - np.sqrt(X**2 + Y**2 + Z**2))).astype(np.float32)


def two_lobes(n=36):
    xs = np.arange(n, dtype=np.float32)
    p = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1) / n - 0.5
    d1 = np.linalg.norm(p - np.array([-0.15, 0, 0]), axis=-1) - 0.22
    d2 = np.linalg.norm(p - np.array([0.15, 0, 0]), axis=-1) - 0.22
    return (-np.minimum(d1, d2)).astype(np.float32)


GRIDS = {"sphere": (sphere_grid, 0.0), "two_lobes": (two_lobes, 0.0)}


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("shape", sorted(GRIDS))
def test_mesh_ops_match_lgm_tpu(shape):
    make, iso = GRIDS[shape]
    grid = make()
    mc = native.marching_cubes(grid, iso)
    _equal(mc, jnative.marching_cubes(grid, iso))
    verts, faces = mc
    assert len(faces) > 100
    verts = verts / (grid.shape[0] - 1) * 2.0 - 1.0
    cl = native.clean(verts, faces, eps=1e-4)
    _equal(cl, jnative.clean(verts, faces, eps=1e-4))
    target = len(cl[1]) // 4
    dec = native.decimate_to_target(*cl, target)
    _equal(dec, jnative.decimate_to_target(*cl, target))
    assert 0 < len(dec[1]) <= 1.5 * target
    dec2 = native.decimate(*cl, 0.1)
    _equal(dec2, jnative.decimate(*cl, 0.1))
    un = native.chart_unwrap(*dec, cos_thresh=0.5)
    _equal(un, jnative.chart_unwrap(*dec, cos_thresh=0.5))
    assert un[3] >= 2


def test_clean_welds_near_duplicates_as_lgm_tpu():
    v, f = native.marching_cubes(sphere_grid(24), 0.0)
    vv = np.concatenate([v, v + 1e-7])
    ff = np.concatenate([f, f + len(v)])
    ours = native.clean(vv, ff)
    _equal(ours, jnative.clean(vv, ff))
    assert len(ours[0]) <= len(v) + 8


def test_library_builds_from_the_port_source(tmp_path, monkeypatch):
    """The library is built by build_host from lgm_tpu_torch/csrc, keyed by
    the source's hash, into build/host/; not lgm_tpu's native/ copy."""
    from lgm_tpu_torch.ops import _build

    so = _build.host_target(native._SRC)
    assert native._SRC.parent.name == "csrc"
    assert native._SRC.parent.parent.name == "lgm_tpu_torch"
    assert so.parent == _build.HOST_BUILD_DIR and so.name.startswith(
        "meshops-")
    native.load_library()
    assert so.exists()
