"""The mesh converter (lgm_tpu_torch/convert.py) against lgm_tpu's
(lgm_tpu/convert.py) from one carried state on the CPU: mixture_field and
the field at 1e-5, the host draws of fit_nerf bit for bit, two fit_nerf
steps (losses, parameters and Adam's moments), one fit_mesh and one
fit_texture step, extract_mesh's density grid, and the box atlas; then the
port's tiny end-to-end conversion and its CLI.

lgm_tpu's steps are jitted closures inside its stage methods: the tests
run those methods as they are, for one or two iterations, with their
teacher renders patched to the port's (lgm_tpu renders through its exact
oracle on the CPU, the port through flatsort: trap C2), and read the
losses and Adam's states out of the jitted steps through
``jax.debug.callback`` on wrapped ``jax.value_and_grad`` and
``optax.adam``. The port starts from lgm_tpu's initial field
(``weights.nerf_params_to_torch``) and takes JAX's jitter draws.

Tolerance: 1e-5 of each tensor's largest value for losses, moments and
fields, except where a test says otherwise and why. Adam's step is
lr * m / (sqrt(v) + eps), about ±lr wherever |g| >> eps, so a parameter
whose gradient is f32 rounding noise around 0 may step the other way in
the two frameworks; parameters are held as ``_held_step`` says.
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lgm_tpu import convert as jconvert
from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.ops.gsplat.projection import quat_to_rotmat as jax_quat
from lgm_tpu_torch import convert
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.io.mesh import load_glb
from lgm_tpu_torch.ops.gsplat.projection import quat_to_rotmat
from lgm_tpu_torch.weights import nerf_params_to_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
# The converter's fit_nerf draws 4,096 rays an iteration; the tests' CPU
# steps, the port's and lgm_tpu's alike, run at that size.
NERF_RES = 64


def ball(n=300, seed=0):
    """tests/test_convert.py's ball of Gaussians (also in
    tests/test_torch_convert_cli.py)."""
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 14), np.float32)
    v = rng.normal(0, 1, (n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    g[:, 0:3] = v * rng.uniform(0, 0.4, (n, 1)) ** (1 / 3)
    g[:, 3] = 0.95
    g[:, 4:7] = 0.08
    g[:, 7] = 1.0
    g[:, 11:14] = np.abs(v) * 0.7 + 0.2
    return g


def _close(ours, ref, what, rtol=RTOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


class Recorder:
    """A numpy Generator proxy recording each draw (method, arguments,
    result)."""

    def __init__(self, rng):
        self._rng = rng
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def call(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((name, args, kw, np.copy(out)))
            return out
        return call


def _same_draws(a, b):
    assert [c[:3] for c in a.calls] == [c[:3] for c in b.calls]
    for x, y in zip(a.calls, b.calls):
        assert np.asarray(x[3]).dtype == np.asarray(y[3]).dtype
        np.testing.assert_array_equal(x[3], y[3])


@pytest.fixture
def jax_taps(monkeypatch):
    """Wrap jax.value_and_grad and optax.adam so lgm_tpu's jitted steps
    report, in step order, each step's loss, the parameters the step
    started from and Adam's state after it."""
    taps = {"loss": [], "params": [], "adam": []}
    vag, adam = jax.value_and_grad, optax.adam
    tree_np = functools.partial(jax.tree_util.tree_map, np.asarray)

    def tapped_vag(fn, *a, **kw):
        inner = vag(fn, *a, **kw)

        def call(*args, **kwargs):
            loss, grads = inner(*args, **kwargs)
            jax.debug.callback(lambda x: taps["loss"].append(float(x)),
                               loss)
            return loss, grads
        return call

    def tapped_adam(lr):
        tx = adam(lr)

        def update(g, state, params=None):
            upd, new = tx.update(g, state, params)
            jax.debug.callback(
                lambda p, s: (taps["params"].append(tree_np(p)),
                              taps["adam"].append(tree_np(s[0]))),
                params, new)
            return upd, new
        return optax.GradientTransformation(tx.init, update)

    monkeypatch.setattr(jax, "value_and_grad", tapped_vag)
    monkeypatch.setattr(optax, "adam", tapped_adam)
    return taps


def _set_adam(optim, param, mu, nu, count):
    optim.state[param] = {"step": torch.tensor(float(count)),
                          "exp_avg": torch.as_tensor(np.array(mu)),
                          "exp_avg_sq": torch.as_tensor(np.array(nu))}


def _held_step(ours_p, ref_p, g, lr, what, rtol=RTOL):
    """Parameters after an Adam step from one state (``g``: the step's
    first moment, or any multiple of its gradient): at ``rtol`` where |g|
    is at least 1e-2 of its largest (a hundred times the gradients'
    summation-order noise, which the moments are held to), unchanged
    (at ``rtol``) where it is 0, and within 2 lr everywhere (an entry
    whose gradient is rounding noise may step the other way)."""
    ours_p, ref_p, g = (np.asarray(a) for a in (ours_p, ref_p, g))
    assert np.abs(ours_p - ref_p).max() <= 2 * lr + 1e-6, what
    live = np.abs(g) >= 1e-2 * np.abs(g).max()
    assert live.any(), what
    _close(ours_p[live], ref_p[live], what, rtol)
    still = g == 0
    if still.any():
        _close(ours_p[still], ref_p[still], what + " (no gradient)", rtol)


def _teacher(port_conv):
    """lgm_tpu's render_gs patched to the port's teacher render."""
    def render_gs(pose, size):
        rgb, alpha, vp = port_conv.render_gs(pose, size)
        return rgb.numpy(), alpha.numpy(), vp
    return render_gs


def _pair(g, seed=0):
    jopt = jax_get_config("nano")
    ours = convert.Converter(get_config("nano"), g, seed=seed, device="cpu")
    ref = jconvert.Converter(jopt, g, seed=seed)
    ref.render_gs = _teacher(convert.Converter(get_config("nano"), g,
                                               device="cpu"))
    return ours, ref


def _initial_nerf_params(ref):
    """lgm_tpu's fit_nerf initial field: init from the converter's key."""
    return ref._field_model().init(ref.key, jnp.zeros((8, 3)))["params"]


def _field_from(params):
    field = convert.NerfField()
    field.load_state_dict(nerf_params_to_torch(params))
    return field


def test_quat_to_rotmat_and_mixture_field_match_jax():
    g = ball()
    g[:, 7:11] = np.random.default_rng(1).normal(0, 1, (300, 4))
    q = g[:, 7:11]
    _close(quat_to_rotmat(torch.as_tensor(q)).numpy(),
           jax_quat(jnp.asarray(q)), "R")
    pts = np.random.default_rng(2).uniform(-0.6, 0.6, (64, 3)).astype(
        np.float32)
    ours = convert.mixture_field(torch.as_tensor(g), torch.as_tensor(pts))
    ref = jconvert.mixture_field(jnp.asarray(g), jnp.asarray(pts))
    for a, b, what in zip(ours, ref, ("sigma", "rgb", "wsum")):
        _close(a.numpy(), b, what)


def test_field_matches_jax():
    ref = jconvert.Converter(jax_get_config("nano"), ball())
    params = _initial_nerf_params(ref)
    # Move the table off its ±1e-4 start so the hash grid matters.
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.5 * rng.normal(0, 1, x.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, params))
    field = _field_from(params)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    sig, rgb = ref._field_model().apply({"params": params}, jnp.asarray(pts))
    ours = field(torch.as_tensor(pts))
    _close(ours[0].detach().numpy(), sig, "sigma")
    _close(ours[1].detach().numpy(), rgb, "rgb")


def test_fit_nerf_two_steps_match_jax(jax_taps):
    """Two fit_nerf iterations of lgm_tpu, and the port's nerf_step run
    from the state each of them started from (parameters and Adam's
    moments carried across) on its own host draws and teacher view: the
    draws bit for bit, each step's loss, Adam's moments and the
    parameters after it."""
    ours, ref = _pair(ball())
    ours.rng, ref.rng = Recorder(ours.rng), Recorder(ref.rng)
    start = _initial_nerf_params(ref)
    key, jitter = ref.key, []
    for _ in range(2):
        key, sub = jax.random.split(key)
        jitter.append(torch.as_tensor(np.array(jax.random.uniform(
            sub, (convert.N_RAYS, convert.N_SAMPLES)))))
    ref.fit_nerf(iters=2, resolution=NERF_RES, log_every=2)
    jax.block_until_ready(ref.nerf_params)
    jax.effects_barrier()
    assert [len(jax_taps[k]) for k in ("loss", "params", "adam")] == [2] * 3
    for a, b in zip(jax.tree_util.tree_leaves(jax_taps["params"][0]),
                    jax.tree_util.tree_leaves(start)):
        np.testing.assert_array_equal(a, b)

    field = _field_from(start)
    optim = convert.adam(field.parameters(), 1e-2)
    grid = convert.OccupancyGrid.dense(64, aabb=1.0)
    names = dict(field.named_parameters())
    after = jax_taps["params"][1:] + [ref.nerf_params]
    for k in range(2):
        if k:  # lgm_tpu's state after step 1
            field.load_state_dict(nerf_params_to_torch(jax_taps["params"][k]))
            prev = jax_taps["adam"][k - 1]
            mu, nu = (nerf_params_to_torch(t) for t in (prev.mu, prev.nu))
            for name, p in names.items():
                _set_adam(optim, p, mu[name], nu[name], prev.count)
        _, rays_o, rays_d, gt_rgb, gt_a, pts3d = ours.nerf_batch(NERF_RES)
        loss = ours.nerf_step(field, optim, grid, rays_o, rays_d, gt_rgb,
                              gt_a, pts3d, jitter[k])
        _close(float(loss), jax_taps["loss"][k], f"loss {k}")
        st = jax_taps["adam"][k]
        mu, nu = (nerf_params_to_torch(t) for t in (st.mu, st.nu))
        ref_p = nerf_params_to_torch(after[k])
        for name, p in names.items():
            # The table's gradient sums up to ~10^3 points a coarse entry
            # in another order: 1e-4.
            tol = 1e-4 if name == "grid.table" else RTOL
            m = optim.state[p]
            _close(m["exp_avg"].numpy(), mu[name], f"mu {name} {k}", tol)
            _close(m["exp_avg_sq"].numpy(), nu[name], f"nu {name} {k}",
                   2 * tol)
            _held_step(p.detach().numpy(), ref_p[name], mu[name], 1e-2,
                       f"param {name} {k}", tol)

    # The host draws: pose, sel, then sample_points' three, twice.
    _same_draws(ours.rng, ref.rng)
    names = [c[0] for c in ref.rng.calls]
    assert names == ["uniform", "uniform", "integers", "integers", "normal",
                     "uniform"] * 2


def test_fit_nerf_runs_the_steps_it_is_given(monkeypatch):
    """fit_nerf itself: two iterations from lgm_tpu's initial field, the
    losses recorded, the field frozen for the later stages."""
    monkeypatch.setattr(convert, "N_RAYS", 512)
    ours = convert.Converter(get_config("nano"), ball(), device="cpu")
    ref = jconvert.Converter(jax_get_config("nano"), ball())
    field = _field_from(_initial_nerf_params(ref))
    ours.new_field = lambda: field
    ours.fit_nerf(iters=2, resolution=NERF_RES, log_every=2)
    assert ours.field is field and not any(
        p.requires_grad for p in field.parameters())
    assert len(ours.losses["nerf"]) == 2
    assert np.isfinite(ours.losses["nerf"]).all()


def test_extract_mesh_density_and_surface_match_jax():
    """The same field's density grid (64 chunks) at 1e-5; marching
    tetrahedra, clean and decimation on one grid, bit for bit; then the
    port's extract_mesh end to end."""
    ours, ref = _pair(ball())
    params = _initial_nerf_params(ref)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.5 * rng.normal(0, 1, x.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, params))
    ref.nerf_params, ref._field = params, ref._field_model()
    ours.field = _field_from(params).requires_grad_(False)
    n = 24
    dens = ours.density_grid(n)
    captured = {}

    def spy(grid, iso):
        captured["grid"] = grid
        return jnative_mc(grid, iso)

    from lgm_tpu import native as jnative
    jnative_mc = jnative.marching_cubes
    try:
        jnative.marching_cubes = spy
        thresh = float(np.median(dens))
        ref.extract_mesh(grid_resolution=n, density_thresh=thresh,
                         target_faces=300)
    finally:
        jnative.marching_cubes = jnative_mc
    _close(dens, captured["grid"], "density grid")
    # The port's extract_mesh on lgm_tpu's grid gives lgm_tpu's mesh.
    ours.density_grid = lambda res: captured["grid"]
    ours.extract_mesh(grid_resolution=n, density_thresh=thresh,
                      target_faces=300)
    np.testing.assert_array_equal(ours.verts, ref.verts)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    assert len(ours.faces) > 0


def _sphere_state(ours, ref):
    """A carried state for the mesh stages: a small sphere mesh and a
    perturbed field in both converters."""
    from lgm_tpu_torch import native

    n = 16
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    v, f = native.marching_cubes(
        (10 * (0.45 - np.sqrt(X**2 + Y**2 + Z**2))).astype(np.float32), 0.0)
    v = (v / (n - 1) * 2 - 1).astype(np.float32)
    params = _initial_nerf_params(ref)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.3 * rng.normal(0, 1, p.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, params))
    for c in (ours, ref):
        c.verts, c.faces = v.copy(), f.copy()
    ref.nerf_params, ref._field = params, ref._field_model()
    ours.field = _field_from(params).requires_grad_(False)
    return v, f


def test_fit_mesh_step_matches_jax(jax_taps):
    """One fit_mesh iteration from one state. Its gradient reaches the
    vertices through interpolate's barycentrics, which divide by small
    faces' screen areas (tests/test_torch_trirast.py's 1e-4): the
    moments and vertices at 1e-4, the loss at 1e-5."""
    ours, ref = _pair(ball(), seed=1)
    _sphere_state(ours, ref)
    ref.fit_mesh(iters=1, resolution=64, log_every=1)
    ours.fit_mesh(iters=1, resolution=64, log_every=1)
    jax.effects_barrier()
    _close(ours.losses["mesh"], jax_taps["loss"], "loss")
    st = ours.mesh_optim.state[ours.mesh_optim.param_groups[0]["params"][0]]
    _close(st["exp_avg"].numpy(), jax_taps["adam"][0].mu, "mu", 1e-4)
    _close(st["exp_avg_sq"].numpy(), jax_taps["adam"][0].nu, "nu", 2e-4)
    _held_step(ours.verts, ref.verts, jax_taps["adam"][0].mu, 1e-3,
               "verts", 1e-4)


def test_fit_texture_step_matches_jax(jax_taps):
    ours, ref = _pair(ball(), seed=2)
    _sphere_state(ours, ref)
    ours.unwrap_uv()
    ref.unwrap_uv()
    np.testing.assert_array_equal(ours.uv, ref.uv)
    assert ours.n_charts == ref.n_charts
    np.testing.assert_array_equal(ours.rng.random(3), ref.rng.random(3))
    ref.fit_texture(iters=1, tex_size=64, resolution=64, log_every=1)
    ours.fit_texture(iters=1, tex_size=64, resolution=64, log_every=1)
    jax.effects_barrier()
    _close(ours.losses["texture"], jax_taps["loss"], "loss")
    st = ours.texture_optim.state[
        ours.texture_optim.param_groups[0]["params"][0]]
    _close(st["exp_avg"].numpy(), jax_taps["adam"][0].mu, "mu")
    _close(st["exp_avg_sq"].numpy(), jax_taps["adam"][0].nu, "nu")
    # The bake (the field's colours at the vertices) at 1e-5, then the
    # step (the texture is clipped to [0, 1] by both).
    _held_step(ours.texture, ref.texture, jax_taps["adam"][0].mu, 1e-2,
               "texture")


def test_unwrap_uv_box_matches_jax():
    ours, ref = _pair(ball())
    _sphere_state(ours, ref)
    ours._unwrap_uv_box()
    ref._unwrap_uv_box()
    for a, b in ((ours.verts, ref.verts), (ours.uv, ref.uv),
                 (ours.faces, ref.faces)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tiny_run(conv, tmp_path, monkeypatch):
    """tests/test_convert.py's sizes (its teacher resolution 48 is not a
    multiple of flatsort's 32² tile: 64 here), 512 rays an iteration."""
    monkeypatch.setattr(convert, "N_RAYS", 512)
    conv.fit_nerf(iters=24, resolution=64, log_every=24)
    conv.extract_mesh(grid_resolution=48, density_thresh=5.0,
                      target_faces=2000)
    assert len(conv.faces) > 50
    ext = conv.verts.max(0) - conv.verts.min(0)
    assert (ext > 0.3).all() and (ext < 1.8).all()
    conv.fit_mesh(iters=6, resolution=64, log_every=6)
    conv.unwrap_uv()
    assert conv.uv.min() >= 0 and conv.uv.max() <= 1
    conv.fit_texture(iters=6, tex_size=128, resolution=64, log_every=6)
    out = str(tmp_path / "mesh.glb")
    conv.export(out)
    verts, faces, uv, tex_png = load_glb(out)
    assert len(verts) == len(conv.verts)
    assert len(faces) == len(conv.faces)
    assert uv is not None and tex_png is not None
    assert tex_png[:8] == b"\x89PNG\r\n\x1a\n"
    conv.export(str(tmp_path / "mesh.obj"))
    assert os.path.getsize(tmp_path / "mesh.obj") > 0


def test_converter_end_to_end(tmp_path, monkeypatch):
    conv = convert.Converter(get_config("nano"), ball(), seed=0,
                             device="cpu")
    _tiny_run(conv, tmp_path, monkeypatch)
    for stage, n in (("nerf", 24), ("mesh", 6), ("texture", 6)):
        assert len(conv.losses[stage]) == n
        assert np.isfinite(conv.losses[stage]).all()
    assert conv.losses["nerf"][-1] < conv.losses["nerf"][0]


def test_extract_mesh_refuses_a_field_without_surface():
    conv = convert.Converter(get_config("nano"), ball(), device="cpu")
    conv.field = conv.new_field().requires_grad_(False)   # sigma ~ 1
    with pytest.raises(RuntimeError, match="no surface"):
        conv.extract_mesh(grid_resolution=16)


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.Converter(get_config("nano"), ball())
