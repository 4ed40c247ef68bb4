"""Port's v1 tiled rasterizer (binning, packing, K3's and K3ᵇ's plain
versions, render_tiled, the ``pallas_v1`` backend and the training graph on
it) vs lgm_tpu's, on the CPU, forward and gradient. lgm_tpu's Pallas
kernels run in interpret mode, as tests/test_tiled.py runs them."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops.gsplat import tiled as jt
from lgm_tpu.ops.gsplat.projection import project_gaussians as jax_project
from lgm_tpu.ops.gsplat.reference import render_reference as jax_reference
from lgm_tpu_torch.ops.gsplat import tiled as tt
from lgm_tpu_torch.ops.gsplat.api import render, render_views
from lgm_tpu_torch.ops.gsplat.projection import project_gaussians
from lgm_tpu_torch.ops.gsplat.reference import render_reference
from lgm_tpu_torch.utils import camera
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOVY = 49.1
TAN = float(np.tan(0.5 * np.deg2rad(FOVY)))
BG = np.float32([0.2, 0.4, 0.6])
# (image size, tile_h, tile_w, max_per_tile)
TILINGS = [(64, 16, 16, 256), (32, 8, 32, 128)]


def scene(n=120, seed=3):
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 14), np.float32)
    g[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    g[:, 3] = rng.uniform(0.2, 1.0, n)
    g[:, 4:7] = rng.uniform(0.02, 0.1, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = rng.uniform(0, 1, (n, 3))
    return g


def layered_scene(n=200, seed=6):
    """140 faint wide splats over the whole image, so that every tile's
    list runs into a second 128-slot chunk with light left, and n - 140
    ordinary ones."""
    rng = np.random.default_rng(seed)
    g = scene(n, seed)
    g[:140, 0:2] = rng.uniform(-0.5, 0.5, (140, 2))
    g[:140, 3] = 0.04
    g[:140, 4:7] = 0.6
    return g


def view_of(el=10.0, az=30.0):
    pose = camera.orbit_camera(el, az, 1.5)
    return camera.build_camera_inputs(pose[None], FOVY, 0.5, 2.5)[
        "cam_view"][0]


def _jax_pass1(g, view, S, th, tw, K):
    """lgm_tpu's pass 1 (render_tiled up to the composite): (idx, counts,
    params_tiles) and the depth-ordered projection they were built from."""
    proj = jax_project(jnp.asarray(g), jnp.asarray(view), S, TAN)
    active = proj.valid & (proj.radius > 0)
    order = jnp.argsort(jnp.where(active, proj.depth, jnp.inf))
    srt = (proj.mean2d[order], proj.conic[order], proj.color[order],
           proj.opacity[order])
    bbox = jt._tile_bboxes(srt[0], proj.radius[order], th, tw, S // th,
                           S // tw)
    idx, counts = jt._bin_tiles(active[order], bbox, S // th, S // tw, K)
    return idx, counts, jt._build_tile_params(srt, idx, S // tw, th, tw), srt


def _torch_pass1(g, view, S, th, tw, K):
    proj = project_gaussians(torch.as_tensor(g), torch.as_tensor(view), S,
                             TAN)
    active = proj.valid & (proj.radius > 0)
    order = torch.argsort(torch.where(
        active, proj.depth, torch.full_like(proj.depth, float("inf"))),
        stable=True)
    bbox = tt._tile_bboxes(proj.mean2d[order], proj.radius[order], th, tw,
                           S // th, S // tw)
    return tt._bin_tiles(active[order], bbox, S // th, S // tw, K)


@pytest.mark.parametrize("S,th,tw,K", TILINGS)
@pytest.mark.parametrize("make", [scene, layered_scene])
def test_bin_tiles_matches_jax(make, S, th, tw, K):
    """Same depth order (stable argsort), same scalar-radius boxes, so the
    per-tile lists are identical: idx (padding N included) and counts,
    also where a list overflows K and keeps its nearest K."""
    g, view = make(200, 6), view_of()
    jidx, jcounts, _, _ = _jax_pass1(g, view, S, th, tw, K)
    idx, counts = _torch_pass1(g, view, S, th, tw, K)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if make is layered_scene:
        assert int(counts.min()) >= min(140, K)
        assert (int(counts.max()) == K) == (K == 128)  # a list overflowed


@pytest.mark.parametrize("S,th,tw,K", TILINGS)
def test_build_tile_params_matches_jax(S, th, tw, K):
    """The packed [T, 16, K] matrix from lgm_tpu's own sorted projection
    and lists: each row to 1e-6 of its largest |value| (f32 products in
    the same order; XLA may fuse a multiply-add), the constant rows
    exactly."""
    g, view = scene(), view_of()
    jidx, _, jparams, srt = _jax_pass1(g, view, S, th, tw, K)
    ours = tt._build_tile_params(
        tuple(torch.as_tensor(np.array(a)) for a in srt),
        torch.as_tensor(np.array(jidx)).long(), S // tw, th, tw).numpy()
    jparams = np.asarray(jparams)
    assert ours.shape == jparams.shape == ((S // th) * (S // tw), 16, K)
    for r in range(16):
        np.testing.assert_allclose(
            ours[:, r], jparams[:, r], rtol=0,
            atol=1e-6 * max(np.abs(jparams[:, r]).max(), 1.0),
            err_msg=f"row {r}")
    for r in (7, 12, 13, 14, 15):
        assert np.all(ours[:, r] == 0.0)
    assert np.all(ours[:, 11] == 1.0)
    np.testing.assert_array_equal(
        tt._pixel_features(th, tw).numpy(),
        np.asarray(jt._pixel_features(th, tw)))


def _composite_case(S, th, tw, K):
    """The layered scene's composite inputs, edited so that every case of
    the chunk loop occurs: every even tile gets three opaque slots in
    front that cover it whole (power 0, opacity 1: alpha clamps at 0.99,
    the tile's transmittance falls to 1e-6 and it stops after its first
    chunk), and the last tile's count is set to 0 (its rows stay: the
    count alone must skip it)."""
    params, counts, pf = tt._prepare_view(
        torch.as_tensor(layered_scene()), torch.as_tensor(view_of()), S, TAN,
        1.0, th, tw, K)
    params, counts = params.detach().clone(), counts.clone()
    params[0::2, 0:6, 0:3] = 0.0
    params[0::2, 6, 0:3] = 1.0
    counts[-1] = 0
    return params, counts, pf


@pytest.mark.parametrize("S,th,tw,K", [(64, 16, 16, 256), (32, 8, 32, 256)])
def test_tile_composite_reference_matches_jax_kernels(S, th, tw, K):
    """K3's and K3ᵇ's plain versions vs the TPU kernels (interpret mode)
    on the same params_tiles, counts and pf. Forward [T, P, 8] to 1e-5
    (f32: the TPU kernel forms power as a matrix product and the
    transmittance as a shift network, the port as sequences). Backward on
    the same fo and a seeded go, per gradient row to 1e-4 of the row's
    largest |value| (sums over the tile's pixels in other orders; the
    suffix taken as U_total − prefix). Covers tiles that stop after their
    first chunk, tiles that run into the second, and a tile of count 0."""
    params, counts, pf = _composite_case(S, th, tw, K)
    work = tt._composite_plain(params, counts, pf)[1]
    assert work[-1] == 0                                  # count 0
    full = counts.long() > 128
    assert bool((work[full] == 1).any())                  # stopped early
    assert bool((work[full] == 2).any())                  # went on
    jp, jc, jpf = (jnp.asarray(x.numpy()) for x in (params, counts, pf))
    jfo = jt._run_fwd(jp, jc, jpf, True)
    fo = tt.tile_composite_reference(params, counts, pf)
    np.testing.assert_allclose(fo.numpy(), np.asarray(jfo), rtol=0,
                               atol=1e-5)
    assert np.all(fo.numpy()[..., 5:] == 0.0)
    assert np.all(fo.numpy()[-1, :, 4] == 1.0)

    go = np.random.default_rng(7).normal(0, 1, fo.shape).astype(np.float32)
    ref = np.asarray(jt._run_bwd(jp, jc, jpf, jfo, jnp.asarray(go), True))
    _, state = tt.tile_composite_reference(params, counts, pf,
                                           return_state=True)
    # The replay, and each chunk on its own from K3's stored state (the
    # kernel's schedule).
    for st in (None, state):
        ours = tt.tile_composite_bwd(
            params, counts, pf, torch.as_tensor(np.array(jfo)),
            torch.as_tensor(go), st).numpy()
        assert ours.shape == ref.shape
        for r in range(16):
            np.testing.assert_allclose(ours[:, r], ref[:, r], rtol=0,
                                       atol=1e-4 * np.abs(ref[:, r]).max(),
                                       err_msg=f"row {r}")
        # Chunks the forward skipped, and the rows with no gradient, are
        # zero.
        chunk_of = np.arange(K) // 128
        skipped = chunk_of[None, :] >= work.numpy()[:, None]   # [T, K]
        assert skipped.any() and np.all(
            ours.transpose(0, 2, 1)[skipped] == 0.0)
        assert np.all(ours[:, [7, 11, 12, 13, 14, 15]] == 0.0)


def _state_case():
    """Faint splats packed at the centre, which fill a 16 x 16 tile's list
    to K = 1,024 without stopping it, and opaque ones on one side, which
    stop other tiles after their first chunk (64², 16 x 16 tiles)."""
    rng = np.random.default_rng(21)
    g = layered_scene()
    n = 2400
    g = np.concatenate([g, np.zeros((n, 14), np.float32)])
    new = g[-n:]
    new[:, 0:3] = rng.normal(0, 0.05, (n, 3))
    new[:, 3] = rng.uniform(0.005, 0.02, n)
    new[:, 4:7] = rng.uniform(0.01, 0.04, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    new[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    new[:, 11:14] = rng.uniform(0, 1, (n, 3))
    new[:300, 0:3] = rng.normal(0, 0.3, (300, 3))
    new[:300, 0] = rng.uniform(0.15, 0.6, 300)
    new[:300, 3] = 1.0
    new[:300, 4:7] = 0.15
    params, counts, pf = tt._prepare_view(
        torch.as_tensor(g), torch.as_tensor(view_of()), 64, TAN, 1.0, 16, 16,
        1024)
    params = params.detach()
    chunks = tt.tile_composite_work(params, counts, pf)["tile_chunks"]
    assert int(counts.max()) == 1024 and int(chunks.max()) == 8
    assert bool((chunks * 128 < counts.long()).any())       # early-out
    return params, counts, pf, chunks


def test_tile_composite_reference_state_is_the_running_state():
    """The plain K3's state: at each 128-slot boundary c, T and the sums
    equal the output of the forward stopped there (counts capped at
    128 c); and a tile's sums at its last composited chunk's boundary,
    carried through that chunk alone, give the output."""
    params, counts, pf, chunks = _state_case()
    out, state = tt.tile_composite_reference(params, counts, pf,
                                             return_state=True)
    T, NC = state.shape[:2]
    assert state.shape == (T, 1024 // 128, 5, pf.shape[0])
    for c in range(NC):
        stopped = tt.tile_composite_reference(
            params, torch.clamp(counts, max=128 * c), pf)
        rows = stopped[..., [4, 0, 1, 2, 3]].transpose(1, 2)
        torch.testing.assert_close(state[:, c], rows, rtol=1e-5, atol=1e-6)
    last = torch.clamp(chunks - 1, min=0)                          # [T]
    slot = torch.arange(params.shape[2])
    rest = torch.where((slot[None, :] < 128 * last[:, None])[:, None, :],
                       torch.zeros_like(params), params)
    tail = tt.tile_composite_reference(
        rest, torch.minimum(counts.long(), 128 * (last + 1)).int(), pf)
    st = state[torch.arange(T), last].transpose(1, 2)             # [T,P,5]
    carried = torch.cat([st[..., 1:5] + st[..., 0:1] * tail[..., 0:4],
                         st[..., 0:1] * tail[..., 4:5]], dim=2)
    torch.testing.assert_close(carried, out[..., 0:5], rtol=1e-5, atol=1e-6)


def test_tile_composite_bwd_reference_state_path_matches_replay():
    """The plain K3ᵇ chunk by chunk from K3's state (last chunk first, so
    none can lean on another) against its replay, on a scene with a full
    tile and tiles that stop early: in f64 1e-9 of each row's scale (one
    function on two schedules); in f32, as the kernel is held, 1e-4."""
    params, counts, pf, chunks = _state_case()
    go = np.random.default_rng(8).normal(0, 1, (params.shape[0],
                                                pf.shape[0], 8))
    for dtype, rel in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        p = params.to(dtype)
        g = torch.as_tensor(go, dtype=dtype)
        fo, state = tt.tile_composite_reference(p, counts, pf,
                                                return_state=True)
        replay = tt.tile_composite_bwd_reference(p, counts, pf, fo, g)
        chunked = tt.tile_composite_bwd_reference(p, counts, pf, fo, g,
                                                  state)
        for r in range(16):
            scale = float(replay[:, r].abs().max())
            torch.testing.assert_close(chunked[:, r], replay[:, r], rtol=0,
                                       atol=rel * scale)
        skipped = (torch.arange(p.shape[2])[None, :] // 128
                   >= chunks[:, None])
        assert torch.all(chunked.transpose(1, 2)[skipped] == 0)


def test_tile_composite_bwd_reference_is_autograd_of_plain_forward():
    """The analytic VJP equals autograd through K3's plain forward, with
    the early-out and the 0.99 clamp in play. Autograd sums the suffix
    backwards, the VJP takes it as U_total − prefix: 1e-4 of each row's
    scale."""
    params, counts, pf = _composite_case(64, 16, 16, 256)
    go = torch.as_tensor(np.random.default_rng(8).normal(
        0, 1, (params.shape[0], pf.shape[0], 8)).astype(np.float32))
    p = params.clone().requires_grad_()
    fo = tt._composite_plain(p, counts, pf)[0]
    (fo * go).sum().backward()
    ours = tt.tile_composite_bwd_reference(params, counts, pf, fo.detach(),
                                           go)
    for r in (0, 1, 2, 3, 4, 5, 6, 8, 9, 10):
        torch.testing.assert_close(
            ours[:, r], p.grad[:, r], rtol=0,
            atol=1e-4 * float(p.grad[:, r].abs().max()))
    # tile_composite routes autograd to the analytic VJP, which starts each
    # chunk from the forward's saved chunk-boundary state.
    p2 = params.clone().requires_grad_()
    (tt.tile_composite(p2, counts, pf) * go).sum().backward()
    _, state = tt.tile_composite_reference(params, counts, pf,
                                           return_state=True)
    assert torch.equal(p2.grad, tt.tile_composite_bwd_reference(
        params, counts, pf, fo.detach(), go, state))


@pytest.mark.parametrize("S,th,tw,K", TILINGS)
def test_render_tiled_matches_jax_and_oracle(S, th, tw, K):
    """render_tiled on the CPU vs lgm_tpu's (interpret): the same lists
    and the same function, so 1e-4; vs the exact oracle 1e-3 (the early-out
    and the expanded quadratic), as tests/test_tiled.py holds lgm_tpu's."""
    g, view = scene(), view_of()
    ours = tt.render_tiled(torch.as_tensor(g), torch.as_tensor(view), S, TAN,
                           torch.as_tensor(BG), tile_h=th, tile_w=tw,
                           max_per_tile=K)
    ref = jt.render_tiled(jnp.asarray(g), jnp.asarray(view), S, TAN,
                          jnp.asarray(BG), tile_h=th, tile_w=tw,
                          max_per_tile=K, interpret=True)
    oracle = render_reference(torch.as_tensor(g), torch.as_tensor(view), S,
                              TAN, torch.as_tensor(BG))
    assert set(ours) == {"image", "alpha"}
    for key in ("image", "alpha"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)
        np.testing.assert_allclose(ours[key].numpy(), oracle[key].numpy(),
                                   atol=1e-3, err_msg=key)


def test_tiled_overflow_keeps_nearest():
    """More splats on one tile than max_per_tile: the nearest K win, so
    the image stays close to the unconstrained oracle (5e-3, the bound of
    tests/test_tiled.py: edge pixels keep a little dropped-tail light), and
    equals lgm_tpu's to 1e-4."""
    rng = np.random.default_rng(0)
    n = 200
    g = np.zeros((n, 14), np.float32)
    g[:, 2] = np.linspace(0.5, -0.5, n)  # stacked along the view axis
    g[:, 3] = 0.9
    g[:, 4:7] = 0.08
    g[:, 7] = 1.0
    g[:, 11:14] = rng.uniform(0, 1, (n, 3))
    view = view_of(0.0, 0.0)
    kw = dict(tile_h=8, tile_w=32, max_per_tile=128)
    ours = tt.render_tiled(torch.as_tensor(g), torch.as_tensor(view), 32,
                           TAN, torch.zeros(3), **kw)["image"].numpy()
    _, counts, _ = tt._prepare_view(torch.as_tensor(g),
                                    torch.as_tensor(view), 32, TAN, 1.0, 8,
                                    32, 128)
    assert int(counts.max()) == 128
    oracle = jax_reference(jnp.asarray(g), jnp.asarray(view), 32, TAN,
                           jnp.zeros(3))["image"]
    ref = jt.render_tiled(jnp.asarray(g), jnp.asarray(view), 32, TAN,
                          jnp.zeros(3), interpret=True, **kw)["image"]
    np.testing.assert_allclose(ours, np.asarray(oracle), atol=5e-3)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-4)


def test_render_tiled_grad_matches_jax_and_oracle():
    """The gradient with respect to the Gaussians through the whole tiled
    path (projection, depth order and its inverse gather, binning without
    gradient, the slot gather's scatter-add, packing, K3ᵇ's plain version)
    vs jax.grad through lgm_tpu's render_tiled (interpret): 3e-4 of the
    largest entry (both f32 in other orders; the chain from the expanded
    coefficients' gradients back to mean and conic subtracts terms tens of
    times the result, so their 1e-6 relative rounding shows as ~1e-4);
    vs the oracle's gradient 2e-3 of its largest (the bound of
    tests/test_tiled.py)."""
    g, view = scene(60, seed=11), view_of()
    S, kw = 32, dict(tile_h=8, tile_w=32, max_per_tile=128)
    tgt = np.random.default_rng(5).uniform(0, 1, (S, S, 3)).astype(
        np.float32)

    def jloss(render, **rkw):
        def loss(gs):
            o = render(gs, jnp.asarray(view), S, TAN, jnp.asarray(BG), **rkw)
            return jnp.mean((o["image"] - jnp.asarray(tgt)) ** 2) \
                + 0.1 * jnp.mean(o["alpha"])
        return np.asarray(jax.grad(loss)(jnp.asarray(g)))

    gt = torch.as_tensor(g).requires_grad_()
    o = tt.render_tiled(gt, torch.as_tensor(view), S, TAN,
                        torch.as_tensor(BG), **kw)
    (((o["image"] - torch.as_tensor(tgt)) ** 2).mean()
     + 0.1 * o["alpha"].mean()).backward()
    ours = gt.grad.numpy()
    ref = jloss(jt.render_tiled, interpret=True, **kw)
    oracle = jloss(jax_reference)
    assert np.isfinite(ours).all() and np.abs(ours).max() > 0
    np.testing.assert_allclose(ours, ref, atol=3e-4 * np.abs(ref).max())
    np.testing.assert_allclose(ours, oracle,
                               atol=2e-3 * np.abs(oracle).max())


def test_render_views_pallas_v1_backend():
    """The public API on this backend: [B, V] shapes, the image clamped
    to [0, 1], alpha with its channel axis, and no depth key even with
    with_depth=True; a loss on scene 0 leaves scene 1 without gradient."""
    g = np.stack([scene(80, 3), scene(80, 4)])
    g[0, :10, 11:14] = 1.0           # with a white background: clamps at 1
    views = np.stack([np.stack([view_of(0, 0), view_of(0, 90)])] * 2)
    kw = dict(tile_h=8, tile_w=32, max_per_tile=128)
    gt = torch.as_tensor(g).requires_grad_()
    out = render_views(gt, torch.as_tensor(views), 32, TAN,
                       backend="pallas_v1", with_depth=True, **kw)
    assert set(out) == {"image", "alpha"}
    assert out["image"].shape == (2, 2, 32, 32, 3)
    assert out["alpha"].shape == (2, 2, 32, 32, 1)
    img = out["image"].detach().numpy()
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    assert not np.allclose(img[0, 0], img[0, 1])
    raw = tt.render_views_tiled(
        torch.as_tensor(g), torch.as_tensor(views), 32, TAN,
        torch.ones(2, 2, 3), **kw)["image"].numpy()
    np.testing.assert_array_equal(img, np.clip(raw, 0.0, 1.0))
    (out["image"][0] ** 2).sum().backward()
    assert gt.grad[0].abs().max() > 0 and torch.all(gt.grad[1] == 0)
    with pytest.raises(ValueError):
        render_views(gt, torch.as_tensor(views), 32, TAN,
                     backend="pallas_v1", tile_h=8, tile_w=32,
                     max_per_tile=100)   # not a multiple of 128
    with pytest.raises(ValueError):
        render_views(gt, torch.as_tensor(views), 32, TAN, backend="v2")


@pytest.mark.parametrize("backend", ["flatsort", "pallas_v1", "reference"])
def test_render_single_view_wrapper(backend):
    """``render``: one view [N, 14] + [4, 4] -> the [0, 0] slice of
    ``render_views``, with depth only where the backend has it."""
    from lgm_tpu.ops.gsplat.api import render as jax_render

    g, view = scene(), view_of()
    out = render(torch.as_tensor(g), torch.as_tensor(view), 32, TAN,
                 torch.as_tensor(BG), backend=backend)
    full = render_views(torch.as_tensor(g)[None],
                        torch.as_tensor(view)[None, None], 32, TAN,
                        torch.as_tensor(BG), backend=backend)
    assert ("depth" in out) == (backend != "pallas_v1")
    assert out["image"].shape == (32, 32, 3)
    for key in out:
        assert out[key].shape[:2] == (32, 32)
        torch.testing.assert_close(out[key], full[key][0, 0].reshape(
            out[key].shape), rtol=0, atol=0)
    # The oracle backend against lgm_tpu's wrapper: exact arithmetic on
    # both sides, f32 order.
    if backend == "reference":
        ref = jax_render(jnp.asarray(g), jnp.asarray(view), 32, TAN,
                         jnp.asarray(BG), backend="xla")
        assert set(ref) == set(out)
        for key in out:
            np.testing.assert_allclose(out[key].numpy(),
                                       np.asarray(ref[key]), atol=1e-5)


def test_kernel_wrappers_reject_what_they_do_not_take():
    params = torch.empty(1, 16, 128, device="meta")
    counts = torch.empty(1, dtype=torch.int32, device="meta")
    pf = torch.empty(64, 8, device="meta")
    with pytest.raises(ValueError):
        tt.tile_composite_fwd(params, counts, pf)
    with pytest.raises(ValueError):
        tt.tile_composite_bwd(params, counts, pf, pf, pf)
    ok = (torch.zeros(1, 16, 128), torch.zeros(1, dtype=torch.int32),
          tt._pixel_features(8, 8))
    with pytest.raises(ValueError):
        tt._check_inputs("k3", ok[0][:, :15].contiguous(), *ok[1:])
    with pytest.raises(ValueError):
        tt._check_inputs("k3", ok[0], ok[1].long(), ok[2])
    with pytest.raises(ValueError):
        tt._check_inputs("k3", ok[0], ok[1], tt._pixel_features(5, 5))
    tt._check_inputs("k3", *ok)


def test_lgm_with_loss_pallas_v1_matches_jax(monkeypatch):
    """The slice as a whole: LGMWithLoss at nano on the ``pallas_v1``
    backend vs lgm_tpu's with ``rasterizer_backend="pallas_v1"``, the same
    converted weights and batch, f32. lgm_tpu's render_views does not pass
    ``interpret`` on this backend, so its ``render_views_tiled`` is
    replaced in-process by the same function with interpret=True. Loss
    terms to 1e-5 relative, each LGM gradient to 1e-3 of its tensor's
    largest |value| plus 1e-6 (the tolerances of
    test_torch_train.py::test_loss_and_grads_match_jax)."""
    from lgm_tpu.config import get_config as jax_get_config
    from lgm_tpu.data.synthetic import make_batch
    from lgm_tpu.models.lgm import LGMWithLoss as JaxLGMWithLoss
    from lgm_tpu_torch.config import get_config
    from lgm_tpu_torch.models.lgm import LGMWithLoss
    from lgm_tpu_torch.weights import flax_params_to_state_dict

    monkeypatch.setattr(jt, "render_views_tiled", functools.partial(
        jt.render_views_tiled, interpret=True))
    jopt = jax_get_config("nano").replace(lambda_scale_reg=0.5,
                                          unet_remat=False)
    batch = make_batch(np.random.default_rng(0), jopt, batch_size=2,
                       n_gaussians=64)
    data = {k: np.asarray(v) for k, v in batch.items() if k != "scenes"}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    bg = jnp.asarray([0.3, 0.6, 0.9], jnp.float32)
    jmodel = JaxLGMWithLoss(jopt, dtype=jnp.float32,
                            rasterizer_backend="pallas_v1")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jdata, bg)["params"]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jdata, bg)
        return out["loss"], out

    jgrads, jout = jax.jit(jax.grad(loss_fn, has_aux=True))(params)

    opt = get_config("nano").replace(lambda_scale_reg=0.5,
                                     mixed_precision="fp32")
    model = LGMWithLoss(opt, dtype=torch.float32, backend="pallas_v1")
    assert model.backend == "pallas_v1"
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           flax_params_to_state_dict(params).items()})
    out = model({k: torch.tensor(v) for k, v in data.items()},
                torch.as_tensor(np.array(bg)))
    out["loss"].backward()
    for key in ("loss", "loss_mse", "loss_reg", "psnr"):
        np.testing.assert_allclose(out[key].item(), float(jout[key]),
                                   rtol=1e-5, err_msg=key)
    ref = flax_params_to_state_dict({"lgm": jgrads["lgm"]})
    named = dict(model.named_parameters())
    assert set(ref) == {k for k, p in named.items() if p.requires_grad}
    for name, g in ref.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0,
                                   atol=1e-3 * np.abs(g).max() + 1e-6,
                                   err_msg=name)


def test_train_cli_runs_pallas_v1_on_cpu(tmp_path):
    """``python -m lgm_tpu_torch.train nano --rasterizer pallas_v1`` on
    the CPU: two steps and both evals through the tiled path end with
    finite losses."""
    import json

    shim = tmp_path / "no_tensorboard" / "tensorboard"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('tensorboard hidden from this test')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(shim.parent), ROOT]))
    ws = str(tmp_path / "ws")
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "lgm_tpu_torch.train", "nano",
         "--device", "cpu", "--rasterizer", "pallas_v1", "--workspace", ws,
         "--total-steps", "2", "--eval-every", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(ws, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    losses = [r[k] for r in records for k in ("train/loss", "eval/loss")
              if k in r]
    assert len(losses) >= 3 and np.isfinite(losses).all(), records
    assert os.path.exists(os.path.join(ws, "ckpt_2"))
