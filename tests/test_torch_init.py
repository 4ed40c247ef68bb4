"""The initial weights of the port's trained modules against lgm_tpu's
(fault C7): the LGM and the random-VGG LPIPS that ``train.create_state``
builds start from flax's initialisers, as lgm_tpu's do (they set no
``kernel_init``): lecun_normal kernels (a normal truncated at ±2σ, of
variance 1/fan_in) and zero biases."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.models.lgm import LGM as JaxLGM
from lgm_tpu.models.lpips import LPIPS as JaxLPIPS
from lgm_tpu_torch import train
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.models.init import TRUNC_STD, init_like_flax_
from lgm_tpu_torch.weights import flax_params_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Spatial sizes the U-Net's levels divide evenly (the parameters do not
# depend on them): nano 2 downsamples, 1 upsample; tiny 4 and 2.
_SIZES = {"nano": (32, 16), "tiny": (32, 8)}


def _kernels(sd):
    """The conv and dense weights of a state dict: name -> array."""
    return {k: np.asarray(v, np.float64) for k, v in sd.items()
            if k.endswith(".weight") and np.asarray(v).ndim in (2, 4)}


@pytest.fixture(scope="module", params=["nano", "tiny"])
def inits(request):
    """(preset, lgm_tpu's initial LGMWithLoss state dict under the port's
    names, the port's ``create_state`` model state dict), LPIPS on."""
    name = request.param
    size, splat = _SIZES[name]
    jopt = jax_get_config(name).replace(input_size=size, splat_size=splat)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    lgm = jax.jit(JaxLGM(jopt, dtype=jnp.float32).init)(
        k1, jnp.zeros((1, jopt.num_input_views, size, size, 9)))
    img = jnp.zeros((1, 16, 16, 3))
    lpips = jax.jit(JaxLPIPS().init)(k2, img, img)
    ref = flax_params_to_state_dict(
        {"lgm": lgm["params"], "lpips_loss": {"m": lpips["params"]}})
    opt = get_config(name).replace(lambda_lpips=1.0)
    ours = {k: v.numpy() for k, v in
            train.create_state(opt, "cpu").model.state_dict().items()}
    return name, ref, ours


def test_same_parameters(inits):
    _, ref, ours = inits
    assert sorted(ref) == sorted(ours)
    for k, v in ref.items():
        assert v.shape == ours[k].shape, k


def test_kernel_variance_matches_lgm_tpu(inits):
    """Each conv and dense kernel of at least 4,096 weights has lgm_tpu's
    variance within ±10% (PyTorch's default init gives about a third)."""
    _, ref, ours = inits
    big = {k: v for k, v in _kernels(ref).items() if v.size >= 4096}
    assert len(big) >= 20
    for k, v in big.items():
        ratio = ours[k].var() / v.var()
        assert 0.9 <= ratio <= 1.1, (k, ratio)


def test_kernels_truncated_and_biases_zero(inits):
    """Every kernel within ±2σ of flax's truncated normal (σ =
    sqrt(1/fan_in) / 0.8796); every bias exactly 0, GroupNorm's scales 1,
    the LPIPS heads 1/C, as lgm_tpu's."""
    _, ref, ours = inits
    kernels = _kernels(ours)
    for k, w in kernels.items():
        fan_in = w[0].size
        sigma = np.sqrt(1.0 / fan_in) / TRUNC_STD
        assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6), k
    for k, v in ours.items():
        if k not in kernels:
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert any(k.endswith(".bias") for k in ours)


@pytest.mark.parametrize("seed", [0, 7])
def test_same_seed_same_weights(seed):
    """``create_state``'s seed fixes the weights, whatever the global RNG
    holds; another seed gives others; the caller's RNG does not move."""
    opt = get_config("nano").replace(lambda_lpips=1.0)
    torch.manual_seed(123)
    a = train.create_state(opt, "cpu", seed=seed).model.state_dict()
    after = torch.rand(3)
    torch.manual_seed(123)
    b = train.create_state(opt, "cpu", seed=seed).model.state_dict()
    assert torch.equal(torch.rand(3), after)
    torch.manual_seed(9)
    c = train.create_state(opt, "cpu", seed=seed + 1).model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["lgm.unet.conv_in.weight"],
                           c["lgm.unet.conv_in.weight"])


def test_init_like_flax_draws_in_module_order():
    """The helper redraws every Conv2d and Linear, in ``modules()`` order,
    from the generator it is given (grouped convs take fan_in per group),
    and leaves other parameters alone."""
    net = torch.nn.Sequential(torch.nn.Conv2d(8, 6, 3, groups=2),
                              torch.nn.GroupNorm(2, 6),
                              torch.nn.Linear(5, 4, bias=False))
    init_like_flax_(net, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(1)
    for m, fan_in in ((net[0], 4 * 9), (net[2], 5)):
        std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
        want = torch.empty(m.weight.shape)
        torch.nn.init.trunc_normal_(want, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        assert torch.equal(m.weight.detach(), want)
    assert torch.equal(net[0].bias.detach(), torch.zeros(6))
    assert torch.equal(net[1].weight.detach(), torch.ones(6))
