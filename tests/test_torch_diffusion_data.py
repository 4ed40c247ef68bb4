"""The finetune's datasets (lgm_tpu_torch/diffusion/data.py) against
lgm_tpu's on the CPU: SyntheticMVData on the same seed and step (the
same numpy stream: cameras and prompts bit for bit, the images through
the port's flatsort against lgm_tpu's renderer to the 1e-3 that flatsort
is held to), and LVISMVData on a small LVIS-layout dataset written by
the port's PNG writer (views nearest the azimuth ring, the elevation
negated, white compositing, the INTER_AREA resize, an unreadable scene
skipped, JPEG views read) with training=False: cameras and prompts bit
for bit, images to 1e-5 (lgm_tpu resizes with cv2, the port with
utils/resize.py)."""

import os

import numpy as np
import pytest

from lgm_tpu.diffusion import data as jdata
from lgm_tpu_torch.diffusion import data as tdata
from lgm_tpu_torch.io import png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_prompts_and_condition_are_lgm_tpus():
    assert tdata._PROMPTS == jdata._PROMPTS
    for el, az in ((0.0, 0.0), (-12.5, 97.0), (30.0, 359.0)):
        np.testing.assert_array_equal(tdata.blender_condition(el, az),
                                      jdata.blender_condition(el, az))


def test_synthetic_mv_data_matches_lgm_tpu():
    ours = tdata.SyntheticMVData(num_frames=4, image_size=32, length=8,
                                 device="cpu")
    ref = jdata.SyntheticMVData(num_frames=4, image_size=32, length=8)
    for step in (0, 9):
        b, r = ours.batch(step, 2), ref.batch(step, 2)
        assert b["prompts"] == r["prompts"]
        np.testing.assert_array_equal(b["camera"], r["camera"])
        assert b["images"].shape == (2, 4, 32, 32, 3)
        assert b["images"].dtype == np.float32
        np.testing.assert_allclose(b["images"], np.asarray(r["images"]),
                                   atol=1e-3, err_msg=str(step))
    # Conditioning rows are radius-1 orthonormal poses; (seed, step %
    # length) fixes the stream.
    p = b["camera"][0, 0].reshape(4, 4)
    np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3), atol=1e-5)
    np.testing.assert_array_equal(ours.batch(1, 2)["images"],
                                  ours.batch(9, 2)["images"])


@pytest.fixture(scope="module")
def lvis_root(tmp_path_factory):
    """Four scenes of six RGBA views at 48² (three with alpha, one
    opaque RGB), one scene whose PNGs are unreadable, and one with too few
    views, in split 00000-09999; one scene in the held-out split."""
    root = tmp_path_factory.mktemp("lvis")
    rng = np.random.default_rng(0)

    def scene(split, name, n_views, channels=4, broken=False):
        d = root / split / name
        d.mkdir(parents=True)
        for v in range(n_views):
            np.save(d / f"{v:03d}.npy",
                    {"elevation": float(rng.uniform(-30, 30)),
                     "azimuth": float(rng.uniform(0, 360)), "radius": 1.5})
            img = rng.integers(0, 256, (48, 48, channels)).astype(np.uint8)
            if broken:
                (d / f"{v:03d}.png").write_bytes(b"not a png")
            else:
                png.write(str(d / f"{v:03d}.png"), img)

    for i in range(3):
        scene("00000-09999", f"chair_{i}", 6)
    scene("00000-09999", "broken_one", 6, broken=True)
    scene("00000-09999", "few", 2)
    scene("00000-09999", "opaque", 6, channels=3)
    scene("40000-49999", "held_out", 6)
    return str(root)


def test_lvis_mv_data_matches_lgm_tpu(lvis_root):
    ours = tdata.LVISMVData(lvis_root, num_frames=4, image_size=32,
                            training=False)
    ref = jdata.LVISMVData(lvis_root, num_frames=4, image_size=32,
                           training=False)
    assert ours.items == ref.items
    assert len(ours) == 6 and not any("held_out" in p for p in ours.items)
    for step in range(3):
        b, r = ours.batch(step, 2), ref.batch(step, 2)
        assert b["prompts"] == r["prompts"], step
        np.testing.assert_array_equal(b["camera"], r["camera"])
        assert b["images"].shape == (2, 4, 32, 32, 3)
        np.testing.assert_allclose(b["images"], r["images"], rtol=0,
                                   atol=1e-5, err_msg=str(step))
    # Unreadable and short scenes are skipped: the batches name only the
    # readable ones (an underscore in the directory becomes a space).
    seen = {p for s in range(3) for p in ours.batch(s, 2)["prompts"]}
    assert seen == {"chair 0", "chair 1", "chair 2", "opaque"}


def test_lvis_mv_data_refuses_a_dataset_with_no_readable_scene(lvis_root):
    ds = tdata.LVISMVData(lvis_root, training=False, scene_dirs=[
        os.path.join(lvis_root, "00000-09999", "broken_one")])
    with pytest.raises(RuntimeError, match="no readable scene"):
        ds.batch(0, 1)


def test_lvis_mv_data_reads_jpeg_views_as_lgm_tpu(tmp_path):
    """A scene whose views are JPEG bytes under the layout's ``NNN.png``
    names (lgm_tpu's native decode sniffs the magic bytes) reads as
    lgm_tpu's LVISMVData reads it; a scene of corrupt JPEGs is skipped as
    a scene of corrupt PNGs is."""
    import cv2

    rng = np.random.default_rng(1)
    for name, broken in (("jpeg_chair", False), ("broken_jpeg", True)):
        d = tmp_path / "00000-09999" / name
        d.mkdir(parents=True)
        for v in range(6):
            np.save(d / f"{v:03d}.npy",
                    {"elevation": float(rng.uniform(-30, 30)),
                     "azimuth": float(rng.uniform(0, 360)), "radius": 1.5})
            y, x = np.mgrid[0:48, 0:48]
            img = np.stack([(x * 5 + 30 * v) % 256, (y * 4) % 256,
                            rng.integers(0, 256, (48, 48))], -1)
            ok, buf = cv2.imencode(".jpg", img.astype(np.uint8),
                                   [cv2.IMWRITE_JPEG_QUALITY, 85])
            data = buf.tobytes()
            (d / f"{v:03d}.png").write_bytes(
                data[:2] + b"garbage" * 8 if broken else data)
    ours = tdata.LVISMVData(str(tmp_path), num_frames=4, image_size=32,
                            training=False)
    ref = jdata.LVISMVData(str(tmp_path), num_frames=4, image_size=32,
                           training=False)
    b, r = ours.batch(0, 1), ref.batch(0, 1)
    assert b["prompts"] == r["prompts"] == ["jpeg chair"]
    np.testing.assert_array_equal(b["camera"], r["camera"])
    np.testing.assert_allclose(b["images"], r["images"], rtol=0, atol=1e-5)
    assert ours.batch(1, 1)["prompts"] == ["jpeg chair"]
