"""The port's hash-grid encoder (lgm_tpu_torch/ops/hashgrid.py) against
lgm_tpu's Flax module with the table carried across: the encoding, and its
gradients with respect to the table and to the points, f32 at 1e-5
relative (of the largest value). The grids have dense and hashed levels."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops.hashgrid import HashGridEncoder as JaxEncoder
from lgm_tpu_torch.ops.hashgrid import HashGridEncoder
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5

# (levels, features, log2 T, base, max): the first has dense levels (4, 6)
# and hashed ones; the second is the converter's own grid at 2^12 entries.
GRIDS = [(6, 2, 10, 4, 64), (12, 2, 12, 16, 512), (3, 4, 14, 8, 32)]


def _close(ours, ref, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(ours) - ref).max())
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} x {scale}"


@pytest.mark.parametrize("grid", GRIDS)
def test_encoder_and_gradients_match_flax(grid):
    L, F, log2t, base, top = grid
    enc = JaxEncoder(num_levels=L, features=F, log2_table_size=log2t,
                     base_resolution=base, max_resolution=top)
    rng = np.random.default_rng(sum(grid))
    # Points in and slightly outside [0, 1]^3 (clamped), plus the corners.
    x = rng.uniform(-0.05, 1.05, (400, 3)).astype(np.float32)
    x[:2] = [[0, 0, 0], [1, 1, 1]]
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # A table far from its ±1e-4 start, so the trilinear weights matter.
    table = rng.normal(0, 1, params["params"]["table"].shape).astype(
        np.float32)
    params = {"params": {"table": jnp.asarray(table)}}
    ours = HashGridEncoder(L, F, log2t, base, top)
    np.testing.assert_array_equal(ours.resolutions(), enc.resolutions())
    dense = [(int(r) + 1) ** 3 <= 1 << log2t for r in ours.resolutions()]
    if grid == GRIDS[0]:
        assert any(dense) and not all(dense)
    with torch.no_grad():
        ours.table.copy_(torch.as_tensor(table))

    xt = torch.tensor(x, requires_grad=True)
    y = ours(xt)
    y_ref = enc.apply(params, jnp.asarray(x))
    assert y.shape == y_ref.shape == (400, L * F)
    _close(y.detach().numpy(), y_ref, "encoding")

    wgt = rng.normal(0, 1, y_ref.shape).astype(np.float32)
    (y * torch.as_tensor(wgt)).sum().backward()
    g_table, g_x = jax.grad(
        lambda p, xx: jnp.sum(enc.apply(p, xx) * wgt), argnums=(0, 1))(
        params, jnp.asarray(x))
    _close(ours.table.grad.numpy(), g_table["params"]["table"], "d table")
    _close(xt.grad.numpy(), g_x, "d x")


def test_init_and_tv_loss():
    gen = torch.Generator().manual_seed(0)
    enc = HashGridEncoder(4, 2, 12, 4, 32, generator=gen)
    t = enc.table.detach()
    assert t.shape == (4, 4096, 2) and float(t.abs().max()) <= 1e-4
    table = np.random.default_rng(1).normal(0, 1, (4, 64, 2)).astype(
        np.float32)
    ref = JaxEncoder.tv_loss({"table": jnp.asarray(table)})
    np.testing.assert_allclose(
        float(HashGridEncoder.tv_loss(torch.as_tensor(table))), float(ref),
        rtol=1e-6)
