"""The port's diffusion finetune against lgm_tpu's on ImageDream's tiny
config (tiny-test-ip) in f32, both from one state, on the same host batch
and seed: prepare_batch (with the reference frame's CLIP features, its
unscaled clean latent and the zero camera row), the U-Net gradients and
two steps, as tests/test_torch_diffusion_train.py holds MVDream's, at its
tolerances; then cond-drop 1.0 on both sides: the null context, zero
image features and a zero reference latent for every scene.

The comparison of gradients runs with cond-drop 0: a dropped scene's
reference frame is the all-zero latent, which enters the tiny U-Net's
first GroupNorm (one channel a group) as a constant map, whose f32
variance is rounding noise amplified by 1/sqrt(eps), so two f32
implementations differ there far beyond any tolerance (the trap of the
sampler's uncond branch, tests/test_torch_diffusion.py::pipes)."""

import numpy as np
import pytest
import torch

from diffusion_twins import (batch_to_jax_layout, check_gradients,
                             check_prepare_batch, check_steps, host_batch,
                             run_twins)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def run():
    out = run_twins("tiny-test-ip", 0.0)
    jt, tt = out.pop("jax_trainer"), out["trainer"]
    data = host_batch(np.random.default_rng(4))
    jt.cond_drop = tt.cond_drop = 1.0
    out["dropped"] = ({k: np.asarray(v)
                       for k, v in jt.prepare_batch(data).items()},
                      tt.prepare_batch(data))
    return out


def test_imagedream_prepare_batch_matches_lgm_tpu(run):
    check_prepare_batch(run)
    tb = run["tb"]
    assert tb["camera"].shape == (2, 5, 16)
    assert not tb["camera"][:, 4].any() and tb["camera"][:, :4].any()
    # The clean reference latent, unscaled: frame 0's latent / 0.18215.
    np.testing.assert_allclose(tb["ip_img"].numpy(),
                               tb["latents"][:, 0].numpy() / 0.18215,
                               rtol=1e-6)


def test_imagedream_gradients_match_lgm_tpu(run):
    check_gradients(run)


def test_imagedream_two_steps_match_lgm_tpu(run):
    check_steps(run)


def test_cond_drop_gives_null_context_and_zero_image_features(run):
    jb, tb = run["dropped"]
    tt = run["trainer"]
    null = tt._null_ctx
    assert torch.equal(tb["context"], null.expand_as(tb["context"]))
    assert not tb["ip_feats"].any() and not tb["ip_img"].any()
    assert tt._encode_prompt("a test object 0").ne(null).any()
    ours = batch_to_jax_layout(tb)
    for k in ("ip_feats", "ip_img"):
        np.testing.assert_array_equal(ours[k], jb[k], err_msg=k)
    np.testing.assert_allclose(ours["context"], jb["context"], rtol=0,
                               atol=1e-5 * np.abs(jb["context"]).max())
