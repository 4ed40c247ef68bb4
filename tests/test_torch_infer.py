"""The inference slice end to end at the nano preset on the CPU: the port's
forward and orbit vs lgm_tpu's on the same weights and views, and the
port's process() writing a .ply that round-trips."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu import infer as jinfer
from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.io.ply import load_ply as jax_load_ply
from lgm_tpu.models.lgm import LGM as JaxLGM
from lgm_tpu_torch import infer
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.io.ply import load_ply
from lgm_tpu_torch.weights import flax_params_to_state_dict, \
    load_state_dict_into
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def nano():
    """Random-init JAX nano LGM (f32), the same weights in the port, four
    seeded views, and the JAX forward's Gaussians."""
    jopt = jax_get_config("nano").replace(unet_remat=False)
    jmodel = JaxLGM(jopt, dtype=jnp.float32)
    x = jnp.zeros((1, 4, jopt.input_size, jopt.input_size, 9), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), x)["params"]
    mv = np.random.default_rng(5).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    g_jax = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(jinfer.build_input(mv, jopt))))
    opt = get_config("nano").replace(mixed_precision="fp32")
    model = infer.load_model(opt, device="cpu")
    load_state_dict_into(model, flax_params_to_state_dict(params))
    return opt, jopt, model, mv, g_jax


def test_forward_matches_jax(nano):
    opt, jopt, model, mv, g_jax = nano
    np.testing.assert_array_equal(infer.build_input(mv, opt),
                                  jinfer.build_input(mv, jopt))
    g = infer.forward_gaussians(model, mv)
    assert g.shape == g_jax.shape == (1, 4 * 16 * 16, 14)
    assert np.abs(g - g_jax).max() <= 1e-4


def test_orbit_frames_match_jax(nano, tmp_path):
    """Port: flatsort + K2's plain version; lgm_tpu on CPU: its exact
    oracle. One 32x32 tile holds all 1024 splats (no truncation), so the
    frames differ only by the 1e-4 early-out and f32 order: <= 2/255."""
    opt, jopt, _, _, g_jax = nano
    ours = infer.render_orbit_video(g_jax[0], opt, n_frames=8, chunk=4,
                                    device="cpu")
    ref = jinfer.render_orbit_video(g_jax[0], jopt, str(tmp_path / "o.mp4"),
                                    n_frames=8, fps=4, chunk=4, n_devices=1)
    assert ours.shape == ref.shape == (8, 32, 32, 3)
    assert ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 2


def test_process_writes_ply_and_video(nano, tmp_path):
    opt, _, model, mv, g_jax = nano
    out = infer.process(opt, mv, str(tmp_path / "obj"), device="cpu",
                        model=model)
    assert np.abs(out["gaussians"] - g_jax).max() <= 1e-4
    assert out["frames"].shape == (180, 32, 32, 3)
    assert os.path.getsize(out["video"]) > 0
    g = out["gaussians"][0]
    kept = g[g[:, 3] >= 0.005]
    back = load_ply(out["ply"])
    assert back.shape == kept.shape
    # Stored pre-activation (logit, log, SH DC) and re-activated on load.
    np.testing.assert_allclose(back, kept, atol=1e-4)
    np.testing.assert_array_equal(back, jax_load_ply(out["ply"]))


def test_main_cli_runs_on_cpu(tmp_path):
    """The CLI path: four image files -> .ply + video in the workspace."""
    import cv2

    rng = np.random.default_rng(2)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"v{i}.png")
        cv2.imwrite(p, rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
        paths.append(p)
    ws = tmp_path / "ws"
    infer.main(["nano", "--mv-images", *paths, "--workspace", str(ws),
                "--device", "cpu"])
    assert (ws / "v0.ply").exists()
    assert any(f.name.startswith("v0.") and f.suffix in (".mp4", ".npy")
               for f in ws.iterdir())


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    opt = get_config("nano")
    mv = np.zeros((4, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.process(opt, mv, "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.render_orbit_video(np.zeros((8, 14), np.float32), opt)
