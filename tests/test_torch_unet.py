"""Port's U-Net and LGM forward vs the reference torch goldens and vs
lgm_tpu's Flax modules (weights passed through flax_params_to_state_dict).

All at f32 on the CPU, where these small U-Nets' attention (head dims
below 32) takes the dense route, as on the card. Goldens use
test_golden_unet.py's tolerances (1e-4 of the output scale). Also the
attention gate itself: its choice of route (LGM big at fp32 and bf16
sends every site to the kernels), and the dense route against lgm_tpu's
dense attention."""

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
from lgm_tpu.models.unet import _attention as jax_attention
from lgm_tpu_torch.models import unet as unet_mod
from lgm_tpu_torch.models.unet import UNet, attention
from lgm_tpu_torch.ops.mha import kernel_takes
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


# (dtype, S, D, route): the 16 LGM-big sites in bf16 (S 4096 / 1024 / 256
# at D 32 / 64 / 64), the same in fp32 (the f32 kernels), a dtype the
# kernels refuse (f16), nano's head dim of 6, and the shapes K1 refuses.
_ROUTES = [
    (torch.bfloat16, 4096, 32, "kernel"), (torch.bfloat16, 1024, 64, "kernel"),
    (torch.bfloat16, 256, 64, "kernel"), (torch.float32, 4096, 32, "kernel"),
    (torch.float32, 256, 64, "kernel"), (torch.float16, 256, 64, "dense"),
    (torch.bfloat16, 256, 6, "dense"),
    (torch.bfloat16, 192, 32, "dense"), (torch.bfloat16, 256, 48, "dense"),
]


@pytest.mark.parametrize("dtype,S,D,route", _ROUTES)
def test_attention_gate_routes_by_dtype_and_shape(dtype, S, D, route,
                                                  monkeypatch):
    """The gate sends attention to mha (K1/K1ᵇ on the card) exactly where
    K1 takes it, and to the dense plain path elsewhere; on a CPU tensor
    the same choice as on the card."""
    assert kernel_takes(dtype, S, S, D, D ** -0.5) == (route == "kernel")
    called = []
    monkeypatch.setattr(unet_mod, "mha",
                        lambda *a: called.append("kernel") or a[0])
    monkeypatch.setattr(unet_mod, "dense_attention",
                        lambda *a: called.append("dense") or a[0])
    x = torch.zeros(1, S, D, dtype=dtype)
    attention(x, x, x, D ** -0.5)
    assert called == [route]


# (dtype, B, S, heads, D, tolerance): fp32 at two head dims, and nano's
# bf16 D = 6. fp32: the same f32 products and softmax, sums in other
# orders (1e-5 of the scale). bf16: both cast the f32 probabilities to
# bf16 and take P.V and its gradients in bf16 with f32 sums, in other
# orders: one bf16 rounding step (2^-8 of the scale).
_DENSE = [("float32", 2, 256, 4, 32, 1e-5), ("float32", 1, 64, 16, 6, 1e-5),
          ("bfloat16", 2, 64, 16, 6, 2.0 ** -8)]


@pytest.mark.parametrize("dtype,B,S,H,D,tol", _DENSE)
def test_dense_attention_matches_jax(dtype, B, S, H, D, tol):
    """The dense route against lgm_tpu's ``_attention`` on the CPU, which
    is ``jax.nn.dot_product_attention`` there: forward and the gradient
    of a seeded linear loss, on seeded inputs, through ``dense_attention``
    and through the port's gate. The gate takes the dense route at D 6
    and, since the f32 kernels, the kernel route at f32 D 32 (K1's and
    K1ᵇ's plain versions on CPU tensors: exact f32 attention), held to
    the same tolerance."""
    rng = np.random.default_rng(S + D)
    q, k, v, g = (rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    jdt = jnp.dtype(dtype)

    def jax_loss(q, k, v):
        o = jax_attention(q, k, v)
        return (o.astype(jnp.float32) * g).sum(), o

    (_, o_jax), grads_jax = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    tdt = getattr(torch, dtype)

    def heads(x):  # [B, S, H, D] -> [B*H, S, D], as MVAttention's
        return torch.as_tensor(x).to(tdt).transpose(1, 2).reshape(
            B * H, S, D).contiguous().requires_grad_()

    def back(x):  # [B*H, S, D] -> [B, S, H, D]
        return x.detach().float().reshape(B, H, S, D).transpose(1, 2).numpy()

    assert kernel_takes(tdt, S, S, D, D ** -0.5) == (D == 32)
    for fn in (unet_mod.dense_attention, attention):
        tq, tk, tv = (heads(x) for x in (q, k, v))
        o = fn(tq, tk, tv, D ** -0.5)
        assert o.dtype == tdt
        o.float().backward(heads(g).detach().float())
        for ours, ref in zip([o] + [t.grad for t in (tq, tk, tv)],
                             [o_jax, *grads_jax]):
            ref = np.asarray(ref.astype(jnp.float32))
            err = np.abs(back(ours) - ref).max()
            assert err <= tol * np.abs(ref).max(), (fn.__name__, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_big_sends_every_site_to_mha(dtype, monkeypatch):
    """LGM big's U-Net at fp32 (``mixed_precision="fp32"``) as at bf16:
    all 16 MVAttention sites (5 at S 4096, D 32; 5 at S 1024 and 6 at S
    256, D 64) go to ``mha`` (K1 and K1ᵇ on the card), none to the dense
    route, in the model's dtype. Run on the meta device at the preset's
    full width and input size (shapes only, no arithmetic)."""
    opt = get_config("big")
    calls = []
    monkeypatch.setattr(unet_mod, "mha", lambda q, k, v, scale: calls.append(
        (q.dtype, q.shape[1], q.shape[2], scale)) or q)
    monkeypatch.setattr(unet_mod, "dense_attention",
                        lambda q, *a: calls.append("dense") or q)
    with torch.device("meta"):
        model = LGM(opt, dtype=dtype)
        x = torch.zeros(opt.num_input_views, 9, opt.input_size,
                        opt.input_size)
        model.unet(x, opt.num_input_views)
    sites = [m for m in model.modules()
             if isinstance(m, unet_mod.MVAttention)]
    assert len(sites) == len(calls) == 16
    assert sorted(c[1:3] for c in calls) == sorted(
        [(4096, 32)] * 5 + [(1024, 64)] * 5 + [(256, 64)] * 6)
    for dt, S, D, scale in calls:
        assert dt is dtype and kernel_takes(dtype, S, S, D, scale)
