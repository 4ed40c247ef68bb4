"""The port's mesh export (lgm_tpu_torch/io/mesh.py) against lgm_tpu's
(lgm_tpu/io/mesh.py) on the same arrays: the .glb geometry and UVs bit for
bit, the texture's decoded pixels equal (the port encodes PNG itself, so
the bytes differ), the .obj text line for line."""

import numpy as np
import pytest

from lgm_tpu.io import mesh as jmesh
from lgm_tpu_torch.io import mesh, png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _arrays(seed=0, nv=37, nf=50, tex=(24, 40)):
    rng = np.random.default_rng(seed)
    verts = rng.normal(0, 0.5, (nv, 3)).astype(np.float32)
    faces = rng.integers(0, nv, (nf, 3)).astype(np.int32)
    uv = rng.uniform(0, 1, (nv, 2)).astype(np.float32)
    # Values outside [0, 1] and on the quantisation steps' edges.
    texture = rng.uniform(-0.2, 1.2, tex + (3,)).astype(np.float32)
    texture[0, :8, 0] = np.arange(8) / 255.0
    return verts, faces, uv, texture


@pytest.mark.parametrize("textured", [True, False])
def test_glb_matches_lgm_tpu(tmp_path, textured):
    verts, faces, uv, texture = _arrays()
    kw = dict(uv=uv, texture=texture) if textured else {}
    ours, ref = str(tmp_path / "ours.glb"), str(tmp_path / "ref.glb")
    mesh.export_glb(ours, verts, faces, **kw)
    jmesh.export_glb(ref, verts, faces, **kw)
    v, f, u, tex = mesh.load_glb(ours)
    jv, jf, ju, jtex = jmesh.load_glb(ref)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(f, faces)
    if not textured:
        assert u is None and ju is None and tex is None and jtex is None
        return
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(u[:, 1], 1 - uv[:, 1])  # v-flip stored
    # Both textures decode to the same uint8 pixels (lgm_tpu's through
    # cv2.imencode of BGR, ours through io/png of RGB).
    ours_px, _ = png.decode_rgba(tex)
    ref_px, _ = png.decode_rgba(jtex)
    np.testing.assert_array_equal(ours_px, ref_px)
    np.testing.assert_array_equal(
        ours_px[..., :3], (np.clip(texture, 0, 1) * 255).astype(np.uint8))
    # lgm_tpu's own reader reads the port's file.
    jv2, jf2, ju2, _ = jmesh.load_glb(ours)
    np.testing.assert_array_equal(jv2, v)
    np.testing.assert_array_equal(ju2, u)


def test_obj_matches_lgm_tpu(tmp_path):
    verts, faces, uv, texture = _arrays(seed=1)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours, ref = str(tmp_path / "a" / "m.obj"), str(tmp_path / "b" / "m.obj")
    mesh.export_obj(ours, verts, faces, uv, texture)
    jmesh.export_obj(ref, verts, faces, uv, texture)
    assert open(ours).read().splitlines() == open(ref).read().splitlines()
    assert (open(ours[:-4] + ".mtl").read()
            == open(ref[:-4] + ".mtl").read())
    np.testing.assert_array_equal(png.imread(ours[:-4] + ".png"),
                                  png.imread(ref[:-4] + ".png"))
    # Untextured: no material, plain faces.
    mesh.export_obj(ours, verts, faces)
    jmesh.export_obj(ref, verts, faces)
    assert open(ours).read() == open(ref).read()
