"""Port's attention (K1's plain version, taken by mha_fwd on CPU tensors)
vs lgm_tpu's K-resident Pallas kernel run in interpret mode."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lgm_tpu.ops.mha import mha_kresident
from lgm_tpu_torch.ops.mha import mha_fwd, mha_reference


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
    o = mha_fwd(*(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                scale)
    assert o.dtype == torch.bfloat16 and mha_fwd.launches == launches
    # Same bf16 inputs, same P rounding; only f32 summation order differs,
    # so the bf16 outputs agree to one bf16 rounding step (2^-8 relative).
    err = np.abs(o.float().numpy() - o_jax).max()
    assert err <= 2.0 ** -8 * np.abs(o_jax).max(), err


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
