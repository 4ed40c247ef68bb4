"""The disk-data slice at nano size on the CPU: the port's decode, the
augmentations, the sample assembly (PNG and JPEG views), both datasets, skip-and-pad, the
decode cache and the loader's batches against lgm_tpu's on the same files
and seeded generators; then the trainer on disk data through its CLI."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import cv2

from lgm_tpu import native
from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.data import provider as jprovider
from lgm_tpu.utils import augment as jaugment
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.data import decode, provider
from lgm_tpu_torch.utils import augment
from test_native_loader import _cv2_reference
from test_provider import _render_views
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not native.dataload_available(), reason="lgm_tpu's native decode is "
    "its default path and the reference here")


def _write_rgba(path, rgb, alpha):
    rgba = np.concatenate([rgb[..., ::-1], alpha[..., None]], axis=-1)
    cv2.imwrite(str(path), (rgba * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def lvis_root(tmp_path_factory):
    """Six LVIS-layout scenes of eight 32² views (as tests/test_provider.py
    writes them): NNN.png RGBA + NNN.npy with the stored elevation
    negated."""
    root = tmp_path_factory.mktemp("lvis")
    for s in range(6):
        scene = root / "00000-09999" / f"scene{s:04d}"
        os.makedirs(scene)
        rgb, alpha, els, azs, _ = _render_views(8, seed=s)
        for v in range(8):
            _write_rgba(scene / f"{v:03d}.png", rgb[v], alpha[v])
            np.save(scene / f"{v:03d}.npy", {"elevation": -els[v],
                                             "azimuth": azs[v],
                                             "radius": 1.5})
    # The test split, which the datasets leave out.
    os.makedirs(root / "40000-49999" / "scene9999")
    return str(root)


@pytest.fixture(scope="module")
def objaverse_root(tmp_path_factory):
    """Three Objaverse-layout objects, 100 views each (12 renders
    repeated), poses stored in Blender world / OpenCV camera form."""
    root = tmp_path_factory.mktemp("objaverse")
    for s in range(3):
        obj = root / f"obj{s:04d}"
        os.makedirs(obj / "rgb")
        os.makedirs(obj / "pose")
        rgb, alpha, _, _, poses = _render_views(12, seed=100 + s)
        for v in range(100):
            _write_rgba(obj / "rgb" / f"{v:03d}.png", rgb[v % 12],
                        alpha[v % 12])
            c2w = poses[v % 12].copy()
            c2w[:3, 1:3] *= -1
            c2w[[1, 2]] = c2w[[2, 1]]
            c2w[1] *= -1
            np.savetxt(obj / "pose" / f"{v:03d}.txt", c2w.reshape(-1)[None],
                       fmt="%.8f")
    return str(root)


def _opts(**kw):
    """The port's and lgm_tpu's nano options with the same overrides."""
    kw = dict(dict(num_input_views=2, num_views=4), **kw)
    return get_config("nano").replace(**kw), jax_get_config("nano").replace(
        **kw)


def _assert_samples_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k],
                                      err_msg=k)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """RGBA PNGs of several sizes (square and not), one without alpha, a
    corrupt one, a truncated one and a missing one."""
    d = tmp_path_factory.mktemp("views")
    rng = np.random.default_rng(3)
    paths = []
    for i, (h, w) in enumerate([(48, 48), (64, 40), (97, 130), (33, 33)]):
        rgba = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
        rgba[..., 3] *= rng.uniform(0, 1, (h, w)) > 0.3
        paths.append(str(d / f"{i:03d}.png"))
        cv2.imwrite(paths[-1], (rgba[..., [2, 1, 0, 3]] * 255).astype(
            np.uint8))
    paths.append(str(d / "noalpha.png"))
    cv2.imwrite(paths[-1], rng.integers(0, 255, (40, 40, 3), np.uint8))
    (d / "corrupt.png").write_bytes(b"\x89PNGgarbage")
    whole = open(paths[0], "rb").read()
    (d / "truncated.png").write_bytes(whole[:len(whole) // 2])
    return paths + [str(d / f) for f in ("corrupt.png", "truncated.png",
                                         "missing.png")]


@pytest.mark.parametrize("sizes", [(32, 24), (48, 0), (33, 97), (40, 130)])
def test_load_views_matches_native(views, sizes):
    """decode.load_views against lgm_tpu.native.load_views (libpng + the
    C++ composite and resize): held to 1e-6, and the arithmetic is the
    same float32 sequence, so it is bit for bit (0.0) here. Identity
    sizes (48 for the 48² view, 33, 40) copy."""
    ours = decode.load_views(views, *sizes)
    ref = native.load_views(views, *sizes, n_threads=2)
    np.testing.assert_array_equal(ours[4], ref[4])
    assert list(ours[4]) == [True] * 5 + [False] * 3
    for a, b in zip(ours[:4], ref[:4]):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a[ours[4]], b[ours[4]], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(a[ours[4]], b[ours[4]])


@pytest.fixture(scope="module")
def jpeg_views(tmp_path_factory):
    """JPEGs written by cv2 (4:2:0, 4:4:4, 4:2:2, gray, and one with
    restart markers), the same kind of bytes under a ``.png`` name (the
    magic bytes decide, as in dataload.cpp::decode_file), a corrupt one
    (SOI then garbage: libjpeg refuses it too) and a missing one."""
    d = tmp_path_factory.mktemp("jpeg_views")
    rng = np.random.default_rng(9)
    paths = []
    specs = [((48, 48), 0x221111, 90, 0), ((64, 40), 0x111111, 75, 0),
             ((97, 130), 0x211111, 60, 0), ((33, 33), None, 80, 0),
             ((50, 70), 0x221111, 85, 3), ((40, 40), 0x221111, 95, 0)]
    for i, ((h, w), sampling, q, rst) in enumerate(specs):
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([(x * 7) % 256, (y * 3 + 20 * i) % 256,
                        (x * y) % 256], -1).astype(np.uint8)
        img[h // 2:h // 2 + 4] = rng.integers(0, 256, (4, w, 3))
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL,
                  rst]
        if sampling is None:
            img = img[..., 0]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
        ext = "png" if i == len(specs) - 1 else "jpg"
        paths.append(str(d / f"{i:03d}.{ext}"))
        ok, buf = cv2.imencode(".jpg", img, params)
        (d / os.path.basename(paths[-1])).write_bytes(buf.tobytes())
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8" + b"garbage" * 8)
    return paths + [str(d / f) for f in ("corrupt.jpg", "missing.jpg")]


@pytest.mark.parametrize("sizes", [(32, 24), (48, 0), (33, 97)])
def test_load_views_on_jpegs_matches_native(jpeg_views, sizes):
    """decode.load_views on JPEG files (and JPEG bytes in a .png file)
    against lgm_tpu.native.load_views (libjpeg + the C++ composite and
    resize): bit for bit, unreadable entries ok False and zero."""
    ours = decode.load_views(jpeg_views, *sizes)
    ref = native.load_views(jpeg_views, *sizes, n_threads=2)
    assert list(ours[4]) == list(ref[4]) == [True] * 6 + [False] * 2
    for a, b in zip(ours[:4], ref[:4]):
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a[ours[4]], b[ours[4]])
        assert not a[~ours[4]].any()


def test_load_views_skips_a_refused_jpeg(jpeg_views, tmp_path):
    """A JPEG the port refuses (progressive) is an unreadable entry, as a
    refused PNG is: ok False and zero pixels, the others decoded."""
    img = cv2.imread(jpeg_views[0], cv2.IMREAD_UNCHANGED)
    prog = str(tmp_path / "progressive.jpg")
    cv2.imwrite(prog, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    rgb, mask, _, _, ok = decode.load_views([jpeg_views[0], prog], 32)
    assert list(ok) == [True, False]
    assert not rgb[1].any() and not mask[1].any() and rgb[0].any()


def test_load_views_matches_cv2_path(views):
    """Against lgm_tpu's cv2 path (LGM_TPU_NATIVE_LOADER=0: cv2.imread,
    composite, cv2.resize INTER_LINEAR) at lgm_tpu's own 2e-3."""
    rgb_a, mask_a, rgb_b, mask_b, ok = decode.load_views(views[:5], 32, 24)
    assert ok.all()
    for i, p in enumerate(views[:5]):
        ra, ma, rb, mb = _cv2_reference(p, 32, 24)
        for ours, ref in ((rgb_a[i], ra), (mask_a[i], ma), (rgb_b[i], rb),
                          (mask_b[i], mb)):
            np.testing.assert_allclose(ours, ref, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations_bit_for_bit(seed):
    """grid_distortion and orbit_camera_jitter draw the same numbers in
    the same order and give the same bits as lgm_tpu's."""
    imgs = np.random.default_rng(50 + seed).uniform(
        0, 1, (3, 24, 20, 3)).astype(np.float32)
    poses = np.stack([jprovider.camera.orbit_camera(10 * i, 40 * i, 1.5)
                      for i in range(3)])
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(augment.grid_distortion(imgs, rng=r1),
                                  jaugment.grid_distortion(imgs, rng=r2))
    np.testing.assert_array_equal(
        augment.orbit_camera_jitter(poses, rng=r1),
        jaugment.orbit_camera_jitter(poses, rng=r2))
    assert r1.random() == r2.random()


@pytest.mark.parametrize("preresized", [True, False])
def test_build_sample_matches_jax(preresized):
    """The sample assembly in training mode, both augmentations on, from
    one seeded generator: lgm_tpu's arrays bit for bit. build_sample
    resizes first through utils/resize.py's copy of cv2's INTER_LINEAR,
    which sums its taps in float64 where cv2 rounds in float32: within
    1e-6 there (measured 5.4e-7)."""
    opt, jopt = _opts(prob_grid_distortion=1.0, prob_cam_jitter=1.0)
    rng = np.random.default_rng(9)
    S = 48
    images = rng.uniform(0, 1, (4, S, S, 3)).astype(np.float32)
    masks = rng.uniform(0, 1, (4, S, S)).astype(np.float32)
    poses = np.stack([jprovider.camera.orbit_camera(5 * i, 70 * i, 1.5)
                      for i in range(4)])
    if preresized:
        args = (images[:2, :32, :32], images[:, :32, :32],
                masks[:, :32, :32, None], poses)
        ours = provider.build_sample_preresized(
            *args, opt, True, np.random.default_rng(1))
        ref = jprovider.build_sample_preresized(
            *args, jopt, True, np.random.default_rng(1))
    else:
        ours = provider.build_sample(images, masks, poses, opt, True,
                                     np.random.default_rng(1))
        ref = jprovider.build_sample(images, masks, poses, jopt, True,
                                     np.random.default_rng(1))
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        return
    _assert_samples_equal(ours, ref)


def test_lvis_eval_samples_match_jax(lvis_root):
    """LVISDataset's split (test split left out), its eval samples (rng
    (13, idx), the elevation sign flip) against lgm_tpu's native path."""
    opt, jopt = _opts(data_path_rendering=lvis_root, batch_size=2)
    for training in (True, False):
        ours = provider.LVISDataset(opt, training=training)
        ref = jprovider.LVISDataset(jopt, training=training)
        assert ours.items == ref.items
        assert len(ours) == (4 if training else 2)
    for i in range(len(ref)):
        _assert_samples_equal(ours[i], ref[i])


def test_objaverse_eval_samples_match_jax(objaverse_root):
    """ObjaverseDataset's eval samples (views 36..72 step 4, rng (7,
    idx), the Blender-to-OpenGL pose flip) against lgm_tpu's."""
    opt, jopt = _opts(data_path=objaverse_root, batch_size=2)
    ours = provider.ObjaverseDataset(opt, training=False)
    ref = jprovider.ObjaverseDataset(jopt, training=False)
    assert ours.items == ref.items and len(ours) == 2
    for i in range(2):
        _assert_samples_equal(ours[i], ref[i])


def test_training_samples_follow_the_contract(lvis_root, objaverse_root):
    """Training samples (fresh entropy, augmentations on) have the
    contract's shapes and finite values."""
    opt, _ = _opts(data_path=objaverse_root, data_path_rendering=lvis_root,
                   batch_size=1)
    for ds in (provider.LVISDataset(opt), provider.ObjaverseDataset(opt)):
        s = ds[0]
        assert s["input"].shape == (2, 32, 32, 9)
        assert s["images_output"].shape == (4, 32, 32, 3)
        assert s["masks_output"].shape == (4, 32, 32, 1)
        assert s["cam_view"].shape == (4, 4, 4)
        assert all(np.isfinite(v).all() for v in s.values())


def test_skip_and_pad_matches_jax(objaverse_root, tmp_path):
    """An object with two readable views (one more corrupt, the rest
    missing): skipped and padded by repetition, as lgm_tpu does."""
    obj = str(tmp_path / "objx")
    shutil.copytree(os.path.join(objaverse_root, "obj0000"), obj)
    for f in sorted(os.listdir(os.path.join(obj, "rgb"))):
        if f not in ("040.png", "044.png", "048.png"):
            os.remove(os.path.join(obj, "rgb", f))
    with open(os.path.join(obj, "rgb", "048.png"), "wb") as fh:
        fh.write(b"\x89PNG corrupt")
    opt, jopt = _opts(batch_size=0)
    ours = provider.ObjaverseDataset(opt, training=False, items=[obj])[0]
    ref = jprovider.ObjaverseDataset(jopt, training=False, items=[obj])[0]
    _assert_samples_equal(ours, ref)
    np.testing.assert_array_equal(ours["images_output"][1],
                                  ours["images_output"][3])


def test_decode_cache_copies_and_keeps_samples(lvis_root, monkeypatch):
    """With LGM_TPU_DECODE_CACHE_MB set, hits are served from copies that
    own their memory (base None), and the samples equal the uncached
    ones."""
    opt, _ = _opts(data_path_rendering=lvis_root, batch_size=2)
    ds = provider.LVISDataset(opt, training=False)
    cold = ds[0]
    monkeypatch.setenv("LGM_TPU_DECODE_CACHE_MB", "64")
    first, second = ds[0], ds[0]
    cache = provider._get_decode_cache()
    assert len(cache.data) > 0
    for views_ in cache.data.values():
        assert all(a.base is None for a in views_)
    _assert_samples_equal(first, cold)
    _assert_samples_equal(second, cold)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_matches_jax_over_two_epochs(lvis_root, workers):
    """The DataLoader's batches over two shuffled epochs: lgm_tpu's Loader
    order (default_rng((seed, epoch))), drop_last, and the same arrays
    (eval samples, so deterministic); the endless stream the trainer
    reads gives the same batches, the epochs one after the other."""
    opt, jopt = _opts(data_path_rendering=lvis_root, batch_size=0)
    ds = provider.LVISDataset(opt, training=False)
    ours = provider.Loader(ds, 2, workers=workers)
    ref = jprovider.Loader(jprovider.LVISDataset(jopt, training=False), 2,
                           workers=2)
    assert len(ours) == len(ref) == 3
    want = []
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        want += list(ref.epoch(epoch))
        assert len(got) == 3
        for b, r in zip(got, want[-3:]):
            _assert_samples_equal({k: v.numpy() for k, v in b.items()}, r)
    ours.close()
    stream = provider.Loader(ds, 2, workers=workers, endless=True)
    it = stream.epoch(0)
    for r in want:
        _assert_samples_equal({k: v.numpy() for k, v in next(it).items()},
                              r)
    stream.close()


def test_train_cli_on_lvis_disk_data(lvis_root, tmp_path):
    """python -m lgm_tpu_torch.train nano --device cpu --data-mode lvis:
    two steps from disk through two loader processes, a finite loss, an
    eval pass and a checkpoint (as tests/test_train_disk.py drives
    lgm_tpu's)."""
    shim = tmp_path / "no_tensorboard" / "tensorboard"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text("raise ImportError('hidden')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(shim.parent), ROOT]))
    ws = str(tmp_path / "ws")
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "lgm_tpu_torch.train", "nano",
         "--device", "cpu", "--data-mode", "lvis",
         "--data-path-rendering", lvis_root, "--workspace", ws,
         "--total-steps", "2", "--num-workers", "2"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    loss = [float(l.split()[3]) for l in proc.stdout.splitlines()
            if l.startswith("step 1:")]
    assert len(loss) == 1 and np.isfinite(loss[0]), proc.stdout
    assert "eval @ 2" in proc.stdout
    assert os.path.exists(os.path.join(ws, "ckpt_2"))
