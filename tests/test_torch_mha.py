"""Port's attention (K1's and K1ᵇ's plain versions, taken by mha_fwd and
mha_bwd on CPU tensors) vs lgm_tpu's K-resident Pallas kernels and their
VJP, run in interpret mode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops.mha import mha_kresident
from lgm_tpu_torch.ops.mha import mha, mha_bwd, mha_fwd, mha_reference
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("S,D", [(256, 32), (256, 64), (512, 32), (512, 64)])
def test_mha_matches_kresident(S, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.normal(0, 1, (2, S, D)).astype(np.float32)
               for _ in range(3))
    scale = float(D) ** -0.5
    o_jax = np.asarray(mha_kresident(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale
    ).astype(jnp.float32))
    launches = mha_fwd.launches
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    o = mha_fwd(tq, tk, tv, scale)
    assert o.dtype == torch.bfloat16 and mha_fwd.launches == launches
    # Same bf16 inputs, same P rounding; only f32 summation order differs,
    # so the bf16 outputs agree to one bf16 rounding step (2^-8 relative).
    err = np.abs(o.float().numpy() - o_jax).max()
    assert err <= 2.0 ** -8 * np.abs(o_jax).max(), err
    # The statistic K1 stores for K1ᵇ: the logsumexp of the scaled logits
    # of the same bf16 inputs, against numpy in f64 (only the f32
    # summation order differs: 1e-5 relative).
    o2, lse = mha_fwd(tq, tk, tv, scale, return_lse=True)
    assert torch.equal(o2, o) and lse.dtype == torch.float32
    assert lse.shape == (2, S)
    logits = np.einsum("bqd,bkd->bqk", *(x.double().numpy()
                                          for x in (tq, tk))) * scale
    m = logits.max(axis=-1)
    want = m + np.log(np.exp(logits - m[..., None]).sum(axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5)


def test_mha_reference_f32_is_softmax_attention():
    """At f32 the plain version is exact softmax attention (no rounding)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, (3, 64, 16)),
                               dtype=torch.float32) for _ in range(3))
    ref = torch.softmax(q @ k.transpose(1, 2) * 0.25, dim=-1) @ v
    torch.testing.assert_close(mha_reference(q, k, v, 0.25), ref,
                               atol=1e-5, rtol=1e-5)


def test_mha_fwd_rejects_other_devices():
    q = torch.empty(1, 64, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        mha_fwd(q, q, q, 1.0)


@pytest.mark.parametrize("S,D", [(256, 32), (256, 64), (512, 32), (512, 64)])
def test_mha_bwd_matches_kresident_vjp(S, D):
    """K1ᵇ's plain version vs jax.vjp of mha_kresident (the TPU backward
    kernel in interpret mode), bf16, from the same q, k, v, o and cotangent
    dO, and the forward's row logsumexp (which the TPU kernel recomputes).
    Both round dO, dS and P to bf16 before their products and sum in f32
    in different orders, so a bf16 dS may round the other way: the bf16
    gradients agree to two rounding steps of their scale (2^-7 of the
    largest |value|)."""
    rng = np.random.default_rng(S * D)
    q, k, v, do = (rng.normal(0, 1, (2, S, D)).astype(np.float32)
                   for _ in range(4))
    scale = float(D) ** -0.5
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o_jax, vjp = jax.vjp(lambda a, b, c: mha_kresident(a, b, c, scale),
                         qj, kj, vj)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]
    o = torch.as_tensor(np.asarray(o_jax.astype(jnp.float32))).to(
        torch.bfloat16)
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    # The statistic from the port's forward on the same inputs, as autograd
    # hands it to K1ᵇ (the TPU backward recomputes it instead).
    _, lse = mha_fwd(tq, tk, tv, scale, return_lse=True)
    ours = mha_bwd(tq, tk, tv, o, torch.as_tensor(do).to(torch.bfloat16),
                   scale, lse)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 2.0 ** -7 * np.abs(b).max(), (name, err)


def test_mha_autograd_is_softmax_attention_gradient():
    """At f32 the autograd path (K1 forward, K1ᵇ backward on CPU tensors:
    their plain versions) gives autograd's own softmax-attention gradient,
    to f32 summation order (1e-5)."""
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.as_tensor(rng.normal(0, 1, (3, 64, 16)),
                                  dtype=torch.float32) for _ in range(4))
    ours = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    out = mha(*ours, 0.25)
    # _MHA's residuals: q, k, v, o and the [BH, S] f32 row logsumexp.
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert saved[4].dtype == torch.float32 and saved[4].shape == (3, 64)
    (out * g).sum().backward()
    (torch.softmax(ref[0] @ ref[1].transpose(1, 2) * 0.25, dim=-1) @ ref[2]
     * g).sum().backward()
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)
    # Without a recorded graph, mha is the plain forward.
    with torch.no_grad():
        torch.testing.assert_close(mha(q, k, v, 0.25),
                                   mha_reference(q, k, v, 0.25))


def test_mha_bwd_rejects_other_devices():
    q = torch.empty(1, 64, 32, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError):
        mha_bwd(q, q, q, q, q, 1.0, lse)
