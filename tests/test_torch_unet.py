"""Port's U-Net and LGM forward vs the reference torch goldens and vs
lgm_tpu's Flax modules (weights passed through flax_params_to_state_dict).

All at f32 on the CPU, where attention takes K1's plain version. Goldens
use test_golden_unet.py's tolerances (1e-4 of the output scale)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.models.lgm import LGM as JaxLGM
from lgm_tpu.models.lgm import activate_gaussians as jax_activate
from lgm_tpu_torch.config import Options, get_config
from lgm_tpu_torch.models.lgm import LGM, activate_gaussians
from lgm_tpu_torch.models.unet import UNet
from lgm_tpu_torch.weights import (flax_params_to_state_dict,
                                   load_reference_weights,
                                   load_state_dict_into)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

_UNETS = {
    "unet_tiny": dict(
        down_channels=(32, 64), down_attention=(False, True),
        mid_attention=True, up_channels=(64, 32),
        up_attention=(True, False)),
    "unet_small_ladder": dict(
        down_channels=(32, 32, 32, 32, 64, 64),
        down_attention=(False, False, False, True, True, True),
        mid_attention=True, up_channels=(64, 64, 32, 32),
        up_attention=(True, True, True, False)),
    "unet_big_ladder": dict(
        down_channels=(32, 32, 32, 32, 64, 64),
        down_attention=(False, False, False, True, True, True),
        mid_attention=True, up_channels=(64, 64, 32, 32, 32),
        up_attention=(True, True, True, False, False)),
}

_LGMS = {
    "lgm_tiny": (4, True),     # (views, attention)
    "lgm_lvis6": (6, False),
}


def _golden(name):
    data = np.load(os.path.join(GOLDEN, name + ".npz"))
    sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    return data, sd


@pytest.mark.parametrize("name", sorted(_UNETS))
def test_unet_matches_reference_golden(name):
    data, sd = _golden(name)
    net = UNet(9, 14, dtype=torch.float32, **_UNETS[name])
    load_state_dict_into(net, {k[len("unet."):]: v for k, v in sd.items()})
    with torch.no_grad():
        y = net(torch.as_tensor(data["input"]), 4).numpy()
    y_ref = data["output"]
    assert y.shape == y_ref.shape
    scale = np.abs(y_ref).max()
    assert np.abs(y - y_ref).max() <= 1e-4 * max(scale, 1.0) + 1e-5


@pytest.mark.parametrize("name", sorted(_LGMS))
def test_lgm_matches_reference_golden(name):
    views, attn = _LGMS[name]
    data, sd = _golden(name)
    opt = Options(
        input_size=16, down_channels=(32, 64),
        down_attention=(False, attn), mid_attention=attn,
        up_channels=(64, 32), up_attention=(attn, False), splat_size=16,
        num_input_views=views)
    model = LGM(opt, dtype=torch.float32)
    load_state_dict_into(model, sd)
    x = torch.as_tensor(data["input"]).permute(0, 1, 3, 4, 2)  # -> NHWC
    with torch.no_grad():
        y = model(x).numpy()
    assert y.shape == data["output"].shape
    assert np.abs(y - data["output"]).max() <= 1e-4


def _jax_nano_lgm(seed=0):
    opt = jax_get_config("nano").replace(unet_remat=False)
    model = JaxLGM(opt, dtype=jnp.float32)
    x = jnp.zeros((1, 4, opt.input_size, opt.input_size, 9), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), x)["params"]
    return model, params


def test_flax_params_convert_into_port():
    """Random-init JAX LGM (nano ladder) -> flax_params_to_state_dict ->
    port LGM: the same Gaussians to 1e-4 (f32 both sides)."""
    jmodel, params = _jax_nano_lgm()
    sd = flax_params_to_state_dict(params)
    model = LGM(get_config("nano"), dtype=torch.float32)
    assert set(sd) == set(model.state_dict())
    load_state_dict_into(model, sd)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 4, 32, 32, 9)).astype(np.float32)
    y_jax = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                             jnp.asarray(x)))
    with torch.no_grad():
        y = model(torch.as_tensor(x)).numpy()
    assert y.shape == (1, 4 * 16 * 16, 14)
    assert np.abs(y - y_jax).max() <= 1e-4


@pytest.mark.parametrize("suffix", [".safetensors", ".pt"])
def test_reference_checkpoint_loads(tmp_path, suffix):
    """--resume: a reference-format state dict file (with an LPIPS key the
    reference checkpoints may carry) loads strictly into the port."""
    data, sd = _golden("lgm_tiny")
    path = str(tmp_path / ("model" + suffix))
    tensors = {k: torch.as_tensor(v) for k, v in sd.items()}
    tensors["lpips.net.0.weight"] = torch.zeros(1)
    if suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file(tensors, path)
    else:
        torch.save({"model": tensors}, path)
    opt = Options(input_size=16, down_channels=(32, 64),
                  down_attention=(False, True), up_channels=(64, 32),
                  up_attention=(True, False), splat_size=16)
    model = LGM(opt, dtype=torch.float32)
    load_reference_weights(model, path)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_activate_gaussians_matches_jax():
    """Including trap C1: rotation normalized along the Gaussian axis, and
    an all-zero rotation column stays zero (eps 1e-12 guard)."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, (2, 64, 14)).astype(np.float32)
    x[0, :, 8] = 0.0
    y = activate_gaussians(torch.as_tensor(x)).numpy()
    y_jax = np.asarray(jax_activate(jnp.asarray(x)))
    np.testing.assert_allclose(y, y_jax, atol=1e-6, rtol=1e-6)
    assert np.all(y[0, :, 8] == 0.0)
    np.testing.assert_allclose(np.linalg.norm(y[1, :, 7], axis=0), 1.0,
                               rtol=1e-5)
