"""The port's ray marcher (lgm_tpu_torch/ops/raymarch.py) against
lgm_tpu's: ray_aabb, the occupancy grid's update and query, and
render_rays at the stratum centres and with JAX's own jitter fed in; f32,
1e-5 absolute on rgb, alpha and depth (all O(1))."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops import raymarch as jr
from lgm_tpu.utils import camera
from lgm_tpu_torch.ops import raymarch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def jax_field(pts, dirs):
    d = jnp.linalg.norm(pts, axis=-1)
    sigma = jnp.where(d < 0.5, 40.0 * (0.5 - d) + 2.0, 0.0)
    return sigma, jnp.stack([jnp.abs(pts[:, 0]), jnp.abs(pts[:, 1]), d], -1)


def torch_field(pts, dirs):
    d = torch.linalg.norm(pts, dim=-1)
    sigma = torch.where(d < 0.5, 40.0 * (0.5 - d) + 2.0, 0.0)
    return sigma, torch.stack([torch.abs(pts[:, 0]), torch.abs(pts[:, 1]),
                               d], -1)


def _rays(el=10.0, az=30.0, n=16):
    ro, rd = camera.get_rays(camera.orbit_camera(el, az, 1.5), n, n, 49.1)
    return (ro.reshape(-1, 3).astype(np.float32),
            rd.reshape(-1, 3).astype(np.float32))


def test_ray_aabb_matches_jax():
    ro, rd = _rays()
    rng = np.random.default_rng(0)
    # Axis-parallel and zero components exercise the 1e-9 / 1e-12 guard.
    extra = np.array([[1, 0, 0], [0, -1, 0], [0, 0, 0], [1e-10, 1, 0]],
                     np.float32)
    rd = np.concatenate([rd, extra])
    ro = np.concatenate([ro, rng.uniform(-2, 2, (4, 3)).astype(np.float32)])
    lo, hi = np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32)
    t0, t1 = raymarch.ray_aabb(*(torch.as_tensor(a) for a in (ro, rd, lo,
                                                                hi)))
    j0, j1 = jr.ray_aabb(*(jnp.asarray(a) for a in (ro, rd, lo, hi)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))


def test_occupancy_update_and_query_match_jax():
    grid = raymarch.OccupancyGrid.dense(16, aabb=1.0)
    jgrid = jr.OccupancyGrid.dense(16, aabb=1.0)
    grid = grid.update(lambda p: torch_field(p, p)[0], threshold=1.0,
                       chunk=512)
    jgrid = jgrid.update(lambda p: jax_field(p, p)[0], threshold=1.0,
                         chunk=512)
    occ = grid.occ.numpy()
    np.testing.assert_array_equal(occ, np.asarray(jgrid.occ))
    assert occ[8, 8, 8] and not occ[0, 0, 0]
    pts = np.random.default_rng(1).uniform(-1.2, 1.2, (2000, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(grid.query(torch.as_tensor(pts)).numpy(),
                                  np.asarray(jgrid.query(jnp.asarray(pts))))


@pytest.mark.parametrize("jittered", [False, True])
def test_render_rays_matches_jax(jittered):
    ro, rd = _rays()
    S = 48
    jgrid = jr.OccupancyGrid.dense(16).update(
        lambda p: jax_field(p, p)[0], threshold=1.0, chunk=512)
    grid = raymarch.OccupancyGrid.dense(16).update(
        lambda p: torch_field(p, p)[0], threshold=1.0, chunk=512)
    key = jax.random.PRNGKey(7) if jittered else None
    jitter = (torch.as_tensor(np.asarray(jax.random.uniform(
        key, (len(ro), S)))) if jittered else None)
    ref = jr.render_rays(jnp.asarray(ro), jnp.asarray(rd), jax_field, jgrid,
                         num_samples=S, rng=key)
    out = raymarch.render_rays(torch.as_tensor(ro), torch.as_tensor(rd),
                               torch_field, grid, num_samples=S,
                               jitter=jitter)
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert float(out["alpha"].max()) > 0.9   # the sphere is hit


def test_render_rays_generator_jitter_is_stratified():
    ro, rd = _rays(n=8)
    grid = raymarch.OccupancyGrid.dense(8)
    gen = torch.Generator().manual_seed(0)
    a = raymarch.render_rays(torch.as_tensor(ro), torch.as_tensor(rd),
                             torch_field, grid, num_samples=16,
                             generator=gen)
    b = raymarch.render_rays(torch.as_tensor(ro), torch.as_tensor(rd),
                             torch_field, grid, num_samples=16)
    assert not torch.equal(a["depth"], b["depth"])
    assert float((a["alpha"] - b["alpha"]).abs().max()) < 0.2
