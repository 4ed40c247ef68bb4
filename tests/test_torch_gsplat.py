"""Port's splat renderer (projection, flatsort binning, K2's and K2ᵇ's plain
versions, the oracle) vs lgm_tpu's, on the CPU, forward and gradient. The
flatsort composite of lgm_tpu runs its Pallas kernels in interpret mode, as
tests/test_flatsort.py does."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops.gsplat import flatsort as jfs
from lgm_tpu.ops.gsplat.projection import project_gaussians as jax_project
from lgm_tpu.ops.gsplat.reference import render_reference as jax_reference
from lgm_tpu.utils import camera as jcamera
from lgm_tpu_torch.ops.gsplat import flatsort as fs
from lgm_tpu_torch.ops.gsplat.api import render_views
from lgm_tpu_torch.ops.gsplat import projection as pj
from lgm_tpu_torch.ops.gsplat.projection import project_gaussians
from lgm_tpu_torch.ops.gsplat.reference import render_reference
from lgm_tpu_torch.utils import camera
from projection_cases import CASES, SIZE, case
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FOVY = 49.1
TAN = float(np.tan(0.5 * np.deg2rad(FOVY)))


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


def view_of(el=10.0, az=30.0):
    pose = camera.orbit_camera(el, az, 1.5)
    return camera.build_camera_inputs(pose[None], FOVY, 0.5, 2.5)[
        "cam_view"][0]


def test_camera_matches_jax():
    from lgm_tpu.config import get_config as jax_get_config
    from lgm_tpu_torch.config import get_config

    poses = np.stack([camera.orbit_camera(el, az, 1.5)
                      for el, az in ((10, 30), (-20, 200), (0, 0))])
    jposes = np.stack([jcamera.orbit_camera(el, az, 1.5)
                       for el, az in ((10, 30), (-20, 200), (0, 0))])
    np.testing.assert_array_equal(poses, jposes)
    cams = camera.build_camera_inputs(poses, FOVY, 0.5, 2.5)
    jcams = jcamera.build_camera_inputs(jposes, FOVY, 0.5, 2.5)
    for key in cams:
        np.testing.assert_array_equal(cams[key], jcams[key])
    emb, p = camera.default_plucker_embedding(get_config("nano"))
    jemb, jp = jcamera.default_plucker_embedding(jax_get_config("nano"))
    np.testing.assert_array_equal(emb, jemb)
    np.testing.assert_array_equal(p, jp)


def test_projection_matches_jax():
    g, view = scene(), view_of()
    ours = project_gaussians(torch.as_tensor(g), torch.as_tensor(view), 64,
                             TAN)
    ref = jax_project(jnp.asarray(g), jnp.asarray(view), 64, TAN)
    for field in ("mean2d", "conic", "depth", "opacity", "color",
                  "attrs_t"):
        a = getattr(ours, field).numpy()
        b = np.asarray(getattr(ref, field))
        # f32 elementwise math in the same order; XLA may fuse into FMAs.
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=field)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    for field in ("radius", "radius_x", "radius_y"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


def _prepare_both(g, view, S, th, tw, dup, mpt):
    params, counts = fs._prepare_view(
        torch.as_tensor(g), torch.as_tensor(view), S, TAN, 1.0, th, tw, dup,
        mpt, True)
    jparams, jcounts = jfs._prepare_view(
        jnp.asarray(g), jnp.asarray(view), S, TAN, 1.0, th, tw, dup, mpt,
        True)
    T, NC, R, G = jparams.shape
    jparams = np.asarray(jparams).transpose(0, 1, 3, 2).reshape(T, NC * G, R)
    return params, counts, jparams, np.array(jcounts)


def test_binning_and_gather_match_jax():
    """Same per-tile counts, same slots in the same order (stable depth
    argsort, first-dup compaction, MPT cap, zero dead slots)."""
    params, counts, jparams, jcounts = _prepare_both(
        scene(), view_of(), 64, 16, 16, 16, 256)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    assert params.shape == jparams.shape
    np.testing.assert_allclose(params.numpy(), jparams, rtol=1e-5, atol=1e-4)


def test_composite_reference_matches_jax_kernel():
    """K2's plain version vs the TPU kernel (interpret mode) on the same
    slot inputs: [T, 8, P] to 1e-5 absolute and 2e-5 relative (f32; the
    TPU kernel's quadratic is a split-K bf16 contraction faithful to ~4e-7
    relative, its transmittance a Hillis-Steele product, and the depth
    row reaches ~2.5)."""
    S, th, tw = 64, 16, 16
    params, counts, jparams, jcounts = _prepare_both(
        scene(), view_of(), S, th, tw, 16, 256)
    T, MPT, R = jparams.shape
    jp = jnp.asarray(jparams.reshape(T, MPT // 128, 128, R)
                     .transpose(0, 1, 3, 2))
    jout = np.asarray(jfs._composite_flat(
        jp, jnp.asarray(jcounts), jfs._pf_split_t(th, tw), True, S // tw, tw,
        th, True))
    out = fs.composite_reference(torch.as_tensor(jparams),
                                 torch.as_tensor(jcounts), th, tw, S // tw)
    np.testing.assert_allclose(out.numpy(), jout, rtol=2e-5, atol=1e-5)


def test_render_views_matches_jax_flatsort():
    """The port's flatsort render on CPU vs lgm_tpu's render_views_flatsort
    (interpret): same binning and truncation, so 1e-4."""
    S, kw = 64, dict(tile_h=16, tile_w=16, dup=16, max_per_tile=256)
    g = np.stack([scene(120, 3), scene(120, 4)])
    views = np.stack([np.stack([view_of(10, 30), view_of(-15, 140)])] * 2)
    bg = np.broadcast_to(np.float32([0.2, 0.4, 0.6]), (2, 2, 3))
    ref = jfs.render_views_flatsort(jnp.asarray(g), jnp.asarray(views), S,
                                    TAN, jnp.asarray(bg), interpret=True,
                                    **kw)
    out = render_views(torch.as_tensor(g), torch.as_tensor(views), S, TAN,
                       torch.tensor([0.2, 0.4, 0.6]), **kw)
    np.testing.assert_allclose(out["image"].numpy(),
                               np.clip(np.asarray(ref["image"]), 0, 1),
                               atol=1e-4)
    np.testing.assert_allclose(out["alpha"][..., 0].numpy(),
                               np.asarray(ref["alpha"]), atol=1e-4)
    np.testing.assert_allclose(out["depth"][..., 0].numpy(),
                               np.asarray(ref["depth"]), atol=1e-4)


def test_oracle_matches_jax_reference():
    g, view = scene(), view_of()
    bg = np.float32([0.2, 0.4, 0.6])
    out = render_reference(torch.as_tensor(g), torch.as_tensor(view), 64,
                           TAN, torch.as_tensor(bg))
    ref = jax_reference(jnp.asarray(g), jnp.asarray(view), 64, TAN,
                        jnp.asarray(bg))
    for key in ("image", "alpha", "depth"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, err_msg=key)


def test_flatsort_matches_oracle():
    """Flatsort (early-out at T <= 1e-4, per-tile caps) vs the exact
    oracle: 1e-3, as tests/test_flatsort.py holds lgm_tpu's."""
    g = torch.as_tensor(scene())
    views = torch.as_tensor(view_of())[None, None]
    kw = dict(tile_h=16, tile_w=16, dup=16)
    fla = render_views(g[None], views, 64, TAN, **kw)
    ref = render_views(g[None], views, 64, TAN, backend="reference")
    for key in ("image", "alpha"):
        np.testing.assert_allclose(fla[key].numpy(), ref[key].numpy(),
                                   atol=1e-3, err_msg=key)
    np.testing.assert_allclose(fla["depth"].numpy(), ref["depth"].numpy(),
                               atol=3e-3)


def test_flatsort_empty_scene():
    """All splats behind the camera: background everywhere, no work."""
    g = scene(16)
    g[:, 2] = 5.0
    view = view_of(0.0, 0.0)
    bg = torch.as_tensor(np.float32([0.3, 0.5, 0.7]))
    out = fs.render_flatsort(torch.as_tensor(g), torch.as_tensor(view), 32,
                             TAN, bg, tile_h=8, tile_w=32, dup=4)
    np.testing.assert_allclose(out["image"].numpy(),
                               np.broadcast_to(bg.numpy(), (32, 32, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(out["alpha"].numpy(), 0.0, atol=1e-6)
    params, counts = fs._prepare_view(
        torch.as_tensor(g), torch.as_tensor(view), 32, TAN, 1.0, 8, 32, 4,
        1024, True)
    assert int(counts.sum()) == 0
    work = fs.composite_work(params, counts, 8, 32, 1)
    assert (work["pairs"], work["used"], work["slots"]) == (0, 0, 0)
    assert torch.all(work["tile_slots"] == 0)


def test_flatsort_dup_overflow_matches_jax():
    """A splat covering more than ``dup`` tiles keeps its first ``dup``
    live tiles: finite, and the same truncation as lgm_tpu's."""
    g = scene(30, seed=9)
    g[0, 4:7] = 0.6
    g[0, 3] = 0.3
    view = view_of()
    params, counts, jparams, jcounts = _prepare_both(g, view, 64, 16, 16, 4,
                                                     1024)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    out = fs.render_flatsort(torch.as_tensor(g), torch.as_tensor(view), 64,
                             TAN, torch.zeros(3), tile_h=16, tile_w=16,
                             dup=4)
    assert np.isfinite(out["image"].numpy()).all()


def test_composite_fwd_rejects_other_devices():
    params = torch.empty(1, 128, 10, device="meta")
    counts = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fs.composite_fwd(params, counts, 32, 32, 1)


def _jax_slots(jparams):
    """[T, MPT, R] slot-major -> lgm_tpu's [T, NC, R, 128] kernel layout."""
    T, MPT, R = jparams.shape
    return jnp.asarray(jparams.reshape(T, MPT // 128, 128, R)
                       .transpose(0, 1, 3, 2))


@pytest.mark.parametrize("with_depth", [True, False])
def test_composite_bwd_reference_matches_jax_vjp(with_depth):
    """K2ᵇ's plain version vs jax.vjp of lgm_tpu's _composite_flat (the
    TPU backward kernel in interpret mode) on the same slots and a seeded
    cotangent, per gradient row to 1e-4 of the row's largest |value|: the
    TPU kernel forms its products from bf16 hi/lo halves (2^-16 relative
    per term), the port in plain f32."""
    S, th, tw = 64, 16, 16
    params, counts, jparams, jcounts = _prepare_both(
        scene(), view_of(), S, th, tw, 16, 256)
    if not with_depth:
        jparams = np.ascontiguousarray(jparams[..., :9])
    T, MPT, R = jparams.shape
    go = np.random.default_rng(7).normal(0, 1, (T, 8, th * tw)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda p: jfs._composite_flat(
        p, jnp.asarray(jcounts), jfs._pf_split_t(th, tw), True, S // tw, tw,
        th, with_depth), _jax_slots(jparams))
    ref = np.asarray(vjp(jnp.asarray(go))[0]).transpose(0, 1, 3, 2).reshape(
        T, MPT, R)
    pt, ct = torch.as_tensor(jparams), torch.as_tensor(jcounts)
    fo, state = fs.composite_reference(pt, ct, th, tw, S // tw,
                                       return_state=True)
    # The replay, and each chunk on its own from K2's stored state (the
    # kernel's schedule).
    for st in (None, state):
        ours = fs.composite_bwd(pt, ct, fo, torch.as_tensor(go), th, tw,
                                S // tw, state=st).numpy()
        assert ours.shape == ref.shape
        for r in range(R):
            np.testing.assert_allclose(ours[..., r], ref[..., r],
                                       atol=1e-4 * np.abs(ref[..., r]).max(),
                                       err_msg=f"row {r}")
        # Slots past each tile's count get zero rows.
        dead = np.arange(MPT)[None, :] >= jcounts[:, None]
        assert np.all(ours[dead] == 0.0)


def test_composite_bwd_reference_is_autograd_of_plain_forward():
    """The analytic VJP equals autograd through K2's plain forward,
    including a tile that stops early at T <= 1e-4 (opaque splats) and
    the 0.99 clamp. Autograd sums the suffix Σ_{j>i} s_j w_j backwards,
    the VJP takes it as U_eff − prefix, which loses f32 digits relative to
    U_eff: 1e-4 of each row's scale."""
    S, th, tw = 64, 16, 16
    g = scene(800, seed=6)
    g[:300, 3] = 1.0         # large opaque splats: clamp and early-out
    g[:300, 4:7] = 0.25
    params, counts = fs._prepare_view(
        torch.as_tensor(g), torch.as_tensor(view_of()), S, TAN, 1.0, th, tw,
        16, 512, True)
    params = params.detach()
    go = torch.as_tensor(np.random.default_rng(8).normal(
        0, 1, (params.shape[0], 8, th * tw)).astype(np.float32))
    p = params.clone().requires_grad_()
    fo = fs._composite_plain(p, counts, th, tw, S // tw)[0]
    (fo * go).sum().backward()
    ours = fs.composite_bwd_reference(params, counts, fo.detach(), go, th,
                                      tw, S // tw)
    work = fs.composite_work(params, counts, th, tw, S // tw)
    assert work["slots"] < int(counts.sum())  # some tile stopped early
    for r in range(params.shape[2]):
        torch.testing.assert_close(
            ours[..., r], p.grad[..., r], rtol=0,
            atol=1e-4 * float(p.grad[..., r].abs().max()))


def _state_scene():
    """Faint splats packed at the centre, which fill tiles to MPT = 1,024
    slots, and opaque ones on one side, which stop other tiles early: at
    64², 16 x 16 tiles, tiles 5 and 9 composite all 1,024 slots and eight
    others stop after their first chunk."""
    rng = np.random.default_rng(21)
    g = scene(2400, seed=21)
    g[:, 0:3] = rng.normal(0, 0.05, (2400, 3))
    g[:, 3] = rng.uniform(0.005, 0.02, 2400)
    g[:, 4:7] = rng.uniform(0.01, 0.04, (2400, 3))
    g[:300, 0:3] = rng.normal(0, 0.3, (300, 3))
    g[:300, 0] = rng.uniform(0.15, 0.6, 300)
    g[:300, 3] = 1.0
    g[:300, 4:7] = 0.15
    S, th, tw = 64, 16, 16
    params, counts = fs._prepare_view(
        torch.as_tensor(g), torch.as_tensor(view_of()), S, TAN, 1.0, th, tw,
        16, 1024, True)
    params = params.detach()
    work = fs.composite_work(params, counts, th, tw, S // tw)
    walked = work["tile_slots"]
    assert int(counts.max()) == 1024 and int(walked.max()) == 1024
    assert bool((walked < counts.long()).any())   # early-out
    return params, counts, (th, tw, S // tw), walked


def test_composite_reference_state_is_the_running_state():
    """The plain K2's state: at each 128-slot boundary c, T and the
    accumulators equal the output of the forward stopped there (counts
    capped at 128 c); and a tile's accumulators at its last composited
    chunk's boundary, carried through that chunk alone, give the
    output."""
    params, counts, tiling, walked = _state_scene()
    out, state = fs.composite_reference(params, counts, *tiling,
                                        return_state=True)
    T, NC = state.shape[:2]
    assert state.shape == (T, 1024 // 128, 6, tiling[0] * tiling[1])
    rows = [4, 0, 1, 2, 3, 5]            # T, r, g, b, alpha, depth
    for c in range(NC):
        stopped = fs.composite_reference(
            params, torch.clamp(counts, max=128 * c), *tiling)
        torch.testing.assert_close(state[:, c], stopped[:, rows], rtol=1e-5,
                                   atol=1e-6)
    # Carry each tile from its last composited chunk's boundary: that
    # chunk alone (the earlier ones zeroed, counts capped at its end).
    last = torch.clamp((walked + 127) // 128 - 1, min=0)          # [T]
    slot = torch.arange(params.shape[1])
    rest = torch.where((slot[None, :] < 128 * last[:, None])[..., None],
                       torch.zeros_like(params), params)
    tail = fs.composite_reference(
        rest, torch.minimum(counts.long(), 128 * (last + 1)).int(), *tiling)
    st = state[torch.arange(T), last]                             # [T,6,P]
    carried = torch.cat([st[:, 1:5] + st[:, 0:1] * tail[:, 0:4],
                         (st[:, 0] * tail[:, 4])[:, None],
                         (st[:, 5] + st[:, 0] * tail[:, 5])[:, None]], 1)
    torch.testing.assert_close(carried, out[:, 0:6], rtol=1e-5, atol=1e-6)


def test_composite_bwd_reference_state_path_matches_replay():
    """The plain K2ᵇ chunk by chunk from K2's state (the chunks taken last
    to first, so none can lean on another) against its replay, on a scene
    with a full tile and tiles that stop early. In f64 the two schedules
    are one function: 1e-9 of each row's scale. In f32 they round apart:
    1e-4 of each row's scale, as the kernel is held (on this scene the
    f32 replay's own d op row is 2.2e-5 of its scale off the f64 one, the
    state path's 1.1e-5)."""
    params, counts, tiling, walked = _state_scene()
    go = np.random.default_rng(8).normal(
        0, 1, (params.shape[0], 8, tiling[0] * tiling[1]))
    for dtype, rel in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        p = params.to(dtype)
        g = torch.as_tensor(go, dtype=dtype)
        fo, state = fs.composite_reference(p, counts, *tiling,
                                           return_state=True)
        replay = fs.composite_bwd_reference(p, counts, fo, g, *tiling)
        chunked = fs.composite_bwd_reference(p, counts, fo, g, *tiling,
                                             state=state)
        for r in range(p.shape[2]):
            scale = float(replay[..., r].abs().max())
            torch.testing.assert_close(chunked[..., r], replay[..., r],
                                       rtol=0, atol=rel * scale)
        # Slots the forward never reached get zero rows on both paths.
        reached = torch.arange(p.shape[1])[None, :] < walked[:, None]
        assert torch.all(chunked[~reached] == 0)
        assert torch.all(replay[~reached] == 0)


def _grad_views(g, views, bg, tgt, S, backend, **kw):
    gt = torch.as_tensor(g).requires_grad_()
    out = render_views(gt, torch.as_tensor(views), S, TAN,
                       torch.as_tensor(bg), backend=backend,
                       with_depth=False, **kw)
    loss = ((out["image"] - torch.as_tensor(tgt)) ** 2).mean() \
        + 0.1 * out["alpha"].mean()
    loss.backward()
    return gt.grad.numpy()


def _jax_grad_views(g, views, bg, tgt, S, backend, **kw):
    from lgm_tpu.ops.gsplat.api import render_views as jax_render_views

    def loss(gs):
        if backend == "flatsort":  # interpret mode, through the same API
            out = jfs.render_views_flatsort(
                gs, jnp.asarray(views), S, TAN, jnp.asarray(bg),
                interpret=True, with_depth=False, **kw)
            out = dict(image=jnp.clip(out["image"], 0.0, 1.0),
                       alpha=out["alpha"][..., None])
        else:
            out = jax_render_views(gs, jnp.asarray(views), S, TAN,
                                   jnp.asarray(bg), backend=backend,
                                   with_depth=False)
        return jnp.mean((out["image"] - jnp.asarray(tgt)) ** 2) \
            + 0.1 * jnp.mean(out["alpha"])

    return np.asarray(jax.grad(loss)(jnp.asarray(g)))


def _grad_case():
    B, V, S = 2, 2, 32
    g = np.stack([scene(60, seed=11), scene(60, seed=12)])
    views = np.stack([np.stack([view_of(5.0, 30.0),
                                view_of(-10.0, 200.0)])] * B)
    bg = np.broadcast_to(np.float32([0.2, 0.4, 0.6]), (B, V, 3)).copy()
    tgt = np.random.default_rng(5).uniform(0, 1, (B, V, S, S, 3)).astype(
        np.float32)
    return g, views, bg, tgt, S


def test_render_views_grad_matches_jax_flatsort():
    """Gradients through the whole flatsort path (projection, binning
    without gradient, permutation, slot gather and its scatter-add, K2ᵇ's
    plain version, packing) over a [2, 2] view grid vs lgm_tpu's flatsort
    (interpret), with_depth=False as the loss renders: the same function,
    so 1e-3 of the largest gradient (the TPU kernels' bf16 hi/lo products;
    as tests/test_flatsort.py holds flatsort to the oracle at 2e-3)."""
    g, views, bg, tgt, S = _grad_case()
    kw = dict(tile_h=8, tile_w=32, dup=16, max_per_tile=256)
    ours = _grad_views(g, views, bg, tgt, S, "flatsort", **kw)
    ref = _jax_grad_views(g, views, bg, tgt, S, "flatsort", **kw)
    assert np.isfinite(ours).all() and np.abs(ours).max() > 0
    np.testing.assert_allclose(ours, ref, atol=1e-3 * np.abs(ref).max())


def test_oracle_grad_matches_jax_reference():
    """The oracle's autograd gradient vs lgm_tpu's reference renderer's
    (exact arithmetic on both sides, f32 order): 1e-4 of the largest."""
    g, views, bg, tgt, S = _grad_case()
    ours = _grad_views(g, views, bg, tgt, S, "reference")
    ref = _jax_grad_views(g, views, bg, tgt, S, "xla")
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_flatsort_grad_matches_oracle_and_reaches_its_scene():
    """Flatsort's gradient vs the oracle's on the same views (2e-3 of the
    largest, as tests/test_flatsort.py); a loss on scene 0 alone gives
    scene 1 exactly zero gradient."""
    g, views, bg, tgt, S = _grad_case()
    kw = dict(tile_h=8, tile_w=32, dup=16)
    fla = _grad_views(g, views, bg, tgt, S, "flatsort", **kw)
    ora = _grad_views(g, views, bg, tgt, S, "reference")
    np.testing.assert_allclose(fla, ora, atol=2e-3 * np.abs(ora).max())
    gt = torch.as_tensor(g).requires_grad_()
    out = render_views(gt, torch.as_tensor(views), S, TAN, with_depth=False,
                       **kw)
    (out["image"][0] ** 2).sum().backward()
    assert gt.grad[0].abs().max() > 0
    assert torch.all(gt.grad[1] == 0)


def test_composite_bwd_rejects_other_devices():
    params = torch.empty(1, 128, 9, device="meta")
    counts = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fs.composite_bwd(params, counts, params, params, 32, 32, 1)


@pytest.mark.parametrize("P", [32, 64, 128, 256, 512, 1024])
def test_launch_shape_gives_whole_warps(P):
    """K2's and K3's launch shape for every tile size the wrappers accept
    (a multiple of 32 pixels, at most 1,024): each built (cluster, pixels a
    thread), reduced by shape alone, gives blocks of whole warps, no larger
    than asked; at 32 x 32 tiles it is the variant asked for. A variant no
    kernel is built for raises."""
    for variant in fs.VARIANTS:
        cs, ppt = fs.launch_shape(P, variant)
        assert (cs, ppt) in fs.VARIANTS
        assert cs <= variant[0] and ppt <= variant[1]
        assert P % (32 * cs * ppt) == 0
        if P == 1024:
            assert (cs, ppt) == variant
    with pytest.raises(ValueError):
        fs.launch_shape(P, (8, 2))


# ---------------------------------------------------------------------------
# The projection's VJP (the backward kernel's plain version) and the
# wrapper the renderers call
# ---------------------------------------------------------------------------

# Max abs error of each gradient column within this share of the column's
# largest |value|: f64 sums in other orders, and f32 round-off (the cases
# read at most 2e-6 in f32, 6e-16 in f64).
VJP_COL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _case(name, dtype=torch.float32):
    g, view, mod = case(name, {torch.float32: np.float32,
                               torch.float64: np.float64}[dtype])
    return torch.as_tensor(g), torch.as_tensor(view), mod


def _cotangents(R, N, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(R, N, generator=gen, dtype=dtype),
            torch.randn(N, generator=gen, dtype=dtype))


def _assert_columns_close(ours, ref, tol):
    scale = ref.abs().amax(dim=0)
    err = (ours - ref).abs().amax(dim=0)
    assert torch.all(err <= tol * scale), (err / scale).max().item()


def _reaches_its_branch(name, g, view, mod):
    """The case's scene reaches the branch it is named for."""
    p = pj._intermediates(g, view, SIZE, TAN, mod)
    if name == "behind":
        assert (~p["front"]).sum() >= 90
    elif name == "clamps":
        lim = p["lim"]
        xr = p["xr"]
        assert (xr > lim).any() and (xr < -lim).any()
        assert ((xr == lim) | (xr == -lim)).sum() == 2
        assert ((p["yr"] == lim) | (p["yr"] == -lim)).sum() == 2
    elif name == "det":
        assert (p["det"] <= 0).any()
    elif name == "faint":
        assert (g[:, 3] < pj.ALPHA_MIN).sum() >= 90
    elif name == "unnormalised":
        norm = g[:, 7:11].norm(dim=1)
        assert (norm < 0.9).any() and (norm > 1.1).any()
    elif name == "scale_modifier":
        assert mod != 1.0


@pytest.mark.parametrize("with_depth", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_project_bwd_reference_is_autograd_of_plain(name, with_depth):
    """``project_gaussians_bwd_reference`` (the backward kernel's plain
    version) against autograd of ``project_gaussians`` for seeded
    cotangents of the slot rows and of ``depth``, in f64 and f32, on a
    scene that reaches the case's branch: behind the near plane, past both
    frustum clamps and exactly on their limits, det <= 0, opacity below
    ALPHA_MIN, an un-normalised quaternion, scale_modifier != 1."""
    for dtype in (torch.float64, torch.float32):
        g, view, mod = _case(name, dtype)
        _reaches_its_branch(name, g, view, mod)
        gl = g.clone().requires_grad_()
        p = project_gaussians(gl, view, SIZE, TAN, mod, with_depth)
        g_attrs, g_depth = _cotangents(p.attrs_t.shape[0], len(g), dtype)
        ((p.attrs_t * g_attrs).sum() + (p.depth * g_depth).sum()).backward()
        ours = pj.project_gaussians_bwd_reference(
            g, view, SIZE, TAN, mod, g_attrs, g_depth)
        _assert_columns_close(ours, gl.grad, VJP_COL_TOL[dtype])
        # Without the depth output's cotangent, and with none at all.
        gl.grad = None
        p = project_gaussians(gl, view, SIZE, TAN, mod, with_depth)
        (p.attrs_t * g_attrs).sum().backward()
        ours = pj.project_gaussians_bwd_reference(g, view, SIZE, TAN, mod,
                                                  g_attrs)
        _assert_columns_close(ours, gl.grad, VJP_COL_TOL[dtype])
        assert torch.all(pj.project_gaussians_bwd_reference(
            g, view, SIZE, TAN, mod) == 0)


@pytest.mark.parametrize("with_depth", [False, True])
def test_project_on_the_cpu_is_project_gaussians(with_depth):
    """The renderers' wrapper on a CPU tensor is ``project_gaussians`` bit
    for bit, forward and gradient, and counts no launch, also in a
    profiled run (``lgm_tpu_torch.trace``)."""
    from lgm_tpu_torch import trace

    g, view, _ = _case("orbit")
    launches = pj.project_fwd.launches, pj.project_bwd.launches
    trace.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        grads = []
        for fn in (pj.project, project_gaussians):
            gl = g.clone().requires_grad_()
            p = fn(gl, view, SIZE, TAN, 0.9, with_depth)
            (p.attrs_t.sum() + p.depth.sum()).backward()
            grads.append(gl.grad)
            if fn is pj.project:
                ours = p
        ref = project_gaussians(g, view, SIZE, TAN, 0.9, with_depth)
    for field in pj.Projected._fields:
        assert torch.equal(getattr(ours, field), getattr(ref, field)), field
    assert ours.attrs_t.shape[0] == (10 if with_depth else 9)
    assert torch.equal(grads[0], grads[1])
    assert (pj.project_fwd.launches, pj.project_bwd.launches) == launches
    assert not any(k.startswith("project_") for k in trace.counters())
    trace.reset()


@pytest.mark.parametrize("with_depth", [False, True])
def test_project_function_routes_the_cotangents(with_depth, monkeypatch):
    """The autograd Function that the kernels run under, with the plain
    versions put in their place: the slot rows' cotangent reaches the
    backward transposed, as flatsort's permute hands it back, with the
    depth output's, and the gradient is autograd's of the plain chain;
    mean2d, conic, the radii and valid carry no gradient."""
    calls = []

    def fwd(*args):
        calls.append("fwd")
        return project_gaussians(*args)

    def bwd(g, view, S, tan, mod, g_attrs=None, g_depth=None):
        calls.append("bwd")
        assert g_attrs.stride() == (1, g_attrs.shape[0])
        return pj.project_gaussians_bwd_reference(g, view, S, tan, mod,
                                                  g_attrs, g_depth)

    monkeypatch.setattr(pj, "project_fwd", fwd)
    monkeypatch.setattr(pj, "project_bwd", bwd)
    g, view, mod = _case("clamps")
    N = len(g)
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(1))
    inv = torch.argsort(perm)
    w = torch.randn(N, 10 if with_depth else 9,
                    generator=torch.Generator().manual_seed(2))
    grads = []
    for run in ("function", "plain"):
        gl = g.clone().requires_grad_()
        if run == "function":
            out = pj._Project.apply(gl, view, SIZE, TAN, mod, with_depth)
            mean2d, conic, depth, radius, valid, rx, ry, attrs_t = out
            assert not any(x.requires_grad for x in (mean2d, conic, radius,
                                                     valid, rx, ry))
        else:
            p = project_gaussians(gl, view, SIZE, TAN, mod, with_depth)
            depth, attrs_t = p.depth, p.attrs_t
        rows = fs._PermuteRows.apply(attrs_t.T, perm, inv)
        ((rows * w[perm]).sum() + depth.sum()).backward()
        grads.append(gl.grad)
    assert calls == ["fwd", "bwd"]
    _assert_columns_close(grads[0], grads[1], VJP_COL_TOL[torch.float32])
