"""The port's triangle rasterizer (lgm_tpu_torch/ops/trirast.py) against
lgm_tpu's on a seeded marching-tetrahedra sphere: rasterize's face ids
exactly and its barycentrics at 1e-5 (the same clip-space input), with a
tile over the candidate cap so the truncation order is held; interpolate
and texture, values and gradients with respect to verts, attrs and the
texture against jax.grad, f32 at 1e-5 of the largest value (interpolate
at 1e-4: the two projections' 4-term dots sum in other orders, so clip
coordinates differ in the last bit, and the barycentrics divide by the
screen area of small faces)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops import trirast as jt
from lgm_tpu.utils import camera
from lgm_tpu_torch import native
from lgm_tpu_torch.ops import trirast
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
INTERP_RTOL = 1e-4
FOVY = 49.1


def _close(ours, ref, what, rtol=RTOL):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(ours) - ref).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


@pytest.fixture(scope="module")
def sphere():
    """A 1.5k-face sphere mesh (vertex order shuffled by a seed, so face
    indices are not spatially sorted) and an orbit view-projection."""
    n = 20
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    grid = (10 * (0.6 - np.sqrt(X**2 + Y**2 + Z**2))).astype(np.float32)
    v, f = native.marching_cubes(grid, 0.0)
    v = (v / (n - 1) * 2 - 1).astype(np.float32)
    rng = np.random.default_rng(3)
    perm = rng.permutation(len(f))
    f = f[perm].astype(np.int32)
    pose = camera.orbit_camera(20.0, 40.0, 1.5)
    vp = camera.build_camera_inputs(pose[None], FOVY, 0.5, 2.5)[
        "cam_view_proj"][0].astype(np.float32)
    return v, f, vp


def test_project_vertices_matches_jax(sphere):
    v, _, vp = sphere
    _close(trirast.project_vertices(torch.as_tensor(v),
                                    torch.as_tensor(vp)).numpy(),
           jt.project_vertices(jnp.asarray(v), jnp.asarray(vp)), "clip")


@pytest.mark.parametrize("cap", [1024, 64, 8])
def test_rasterize_matches_jax(sphere, cap):
    """Same clip-space vertices into both; at cap 64 and 8 tiles hold more
    covering faces than the cap, and both keep the first ``cap`` in
    face-index order."""
    v, f, vp = sphere
    clip = np.asarray(jt.project_vertices(jnp.asarray(v), jnp.asarray(vp)))
    ref = jt.rasterize(jnp.asarray(clip), jnp.asarray(f), 64,
                       max_faces_per_tile=cap)
    out = trirast.rasterize(torch.as_tensor(clip),
                            torch.as_tensor(f, dtype=torch.int64), 64,
                            max_faces_per_tile=cap)
    fid = out["face_id"].numpy()
    np.testing.assert_array_equal(fid, np.asarray(ref["face_id"]))
    if cap == 1024:
        assert (fid >= 0).mean() > 0.3
    np.testing.assert_allclose(out["bary"].numpy(), np.asarray(ref["bary"]),
                               rtol=0, atol=1e-5)
    over = int((out["tile_faces"] > cap).sum())
    assert (over > 0) == (cap < 1024)


def test_rasterize_occlusion_and_windings():
    """Two quads at different depths, the near one wound the other way:
    the near one wins where both cover (both windings rasterized). The
    view is off-axis: seen head-on, pixel centres sit exactly on the
    quads' diagonals, where an edge function is 0 up to its last bit and
    XLA's fused multiply-adds may round it to the other side."""
    quad = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                     [-0.5, 0.5, 0]], np.float32)
    verts = np.concatenate([quad - [0, 0, 0.5], quad + [0, 0, 0.5]]).astype(
        np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6]],
                     np.int32)
    pose = camera.orbit_camera(3.0, 7.0, 1.5)
    vp = camera.build_camera_inputs(pose[None], FOVY, 0.5, 2.5)[
        "cam_view_proj"][0].astype(np.float32)
    clip = trirast.project_vertices(torch.as_tensor(verts),
                                    torch.as_tensor(vp))
    fid = trirast.rasterize(clip, torch.as_tensor(faces).long(), 32,
                            max_faces_per_tile=128)["face_id"]
    ref = jt.rasterize(jnp.asarray(clip.numpy()), jnp.asarray(faces), 32,
                       max_faces_per_tile=128)["face_id"]
    np.testing.assert_array_equal(fid.numpy(), np.asarray(ref))
    assert int(fid[16, 16]) >= 2


def test_interpolate_values_and_gradients_match_jax(sphere):
    v, f, vp = sphere
    S = 64
    rng = np.random.default_rng(4)
    attrs = rng.uniform(0, 1, (len(v), 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (S, S, 3)).astype(np.float32)
    clip = jt.project_vertices(jnp.asarray(v), jnp.asarray(vp))
    fid = np.asarray(jt.rasterize(clip, jnp.asarray(f), S)["face_id"])

    def jloss(vv, aa):
        out, mask = jt.interpolate(aa, jnp.asarray(f), jnp.asarray(fid), vv,
                                   jnp.asarray(vp), S)
        return jnp.mean((out - tgt) ** 2), (out, mask)

    (lj, (oj, mj)), (gvj, gaj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(v),
                                             jnp.asarray(attrs))
    vt = torch.tensor(v, requires_grad=True)
    at = torch.tensor(attrs, requires_grad=True)
    out, mask = trirast.interpolate(at, torch.as_tensor(f).long(),
                                    torch.as_tensor(fid).long(), vt,
                                    torch.as_tensor(vp), S)
    loss = torch.mean((out - torch.as_tensor(tgt)) ** 2)
    loss.backward()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mj))
    _close(out.detach().numpy(), oj, "interpolated", INTERP_RTOL)
    _close(float(loss), float(lj), "loss", INTERP_RTOL)
    _close(vt.grad.numpy(), gvj, "d verts", INTERP_RTOL)
    _close(at.grad.numpy(), gaj, "d attrs", INTERP_RTOL)
    assert float(vt.grad.abs().max()) > 0


def test_texture_values_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    tex = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    # In range, at the borders and outside them (clamped addressing).
    uv = rng.uniform(-0.1, 1.1, (40, 30, 2)).astype(np.float32)
    w = rng.normal(0, 1, (40, 30, 3)).astype(np.float32)
    val_j, g_j = jax.value_and_grad(
        lambda t: jnp.sum(jt.texture(t, jnp.asarray(uv)) * w))(
        jnp.asarray(tex))
    tt = torch.tensor(tex, requires_grad=True)
    out = trirast.texture(tt, torch.as_tensor(uv))
    (out * torch.as_tensor(w)).sum().backward()
    _close(out.detach().numpy(), jt.texture(jnp.asarray(tex),
                                            jnp.asarray(uv)), "texture")
    _close(tt.grad.numpy(), g_j, "d texture")
    # A texel centre samples that texel.
    one = torch.arange(16.0).reshape(4, 4, 1)
    got = trirast.texture(one, torch.tensor([[(0.5 + 1) / 4, (0.5 + 2) / 4]]))
    assert abs(float(got[0, 0]) - 9.0) < 1e-5


def test_render_mesh_rasterizes_detached_vertices(sphere):
    v, f, vp = sphere
    vt = torch.tensor(v, requires_grad=True)
    attrs = torch.as_tensor(v * 0.5 + 0.5)
    out, mask = trirast.render_mesh(vt, torch.as_tensor(f).long(), attrs,
                                    torch.as_tensor(vp), 32)
    ref, jmask = jt.render_mesh(jnp.asarray(v), jnp.asarray(f),
                                jnp.asarray(v * 0.5 + 0.5), jnp.asarray(vp),
                                32)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _close(out.detach().numpy(), ref, "render_mesh", INTERP_RTOL)
    out.sum().backward()
    assert vt.grad is not None and torch.isfinite(vt.grad).all()
