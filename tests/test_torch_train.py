"""The training slice at nano size on the CPU: the port's LPIPS, resize,
synthetic batches, loss graph, optimizer and train step vs lgm_tpu's on
the same numpy inputs and converted weights; checkpoints, resume and the
CLI of lgm_tpu_torch.train."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu_torch import train
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.models.lgm import LGMWithLoss, _resize_nchw_256
from lgm_tpu_torch.models.lpips import (LPIPS, load_lpips_params,
                                        load_lpips_state,
                                        lpips_state_from_torch)
from lgm_tpu_torch.weights import flax_params_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden", "lpips_tiny.npz")
LPIPS_STAGES = ((2, 8), (2, 16), (3, 32), (3, 32), (3, 32))


def _np_data(batch):
    return {k: np.asarray(v) for k, v in batch.items() if k != "scenes"}


def _torch_data(data):
    return {k: torch.tensor(np.asarray(v)) for k, v in data.items()}


@pytest.fixture(scope="module")
def nano_batch():
    from lgm_tpu.data.synthetic import make_batch

    jopt = jax_get_config("nano").replace(lambda_lpips=1.0,
                                          lambda_scale_reg=0.5,
                                          unet_remat=False)
    batch = make_batch(np.random.default_rng(0), jopt, batch_size=2,
                       n_gaussians=64)
    return jopt, _np_data(batch)


def test_lpips_canonical_names_golden(tmp_path):
    """The port's LPIPS on the golden fixture (reduced widths, VGG-16
    structure): loaded from its canonical torch names, and from the .npz
    lgm_tpu's converter writes; distances to 1e-5, as tests/test_lpips.py
    holds lgm_tpu's."""
    from lgm_tpu.tools.convert_lpips import convert

    data = np.load(GOLD)
    sd = {k.split("/", 1)[1]: data[k] for k in data.files
          if k.startswith(("vgg_sd/", "lin_sd/"))}
    a = torch.as_tensor(data["a"].transpose(0, 2, 3, 1))  # NCHW -> NHWC
    b = torch.as_tensor(data["b"].transpose(0, 2, 3, 1))

    model = LPIPS(LPIPS_STAGES)
    state = lpips_state_from_torch(sd)
    assert len(state) == 31
    load_lpips_state(model, state)
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_allclose(model(a, b).numpy(), data["dist"], atol=1e-5)
    np.testing.assert_allclose(model(a, a).numpy(), data["dist_same"],
                               atol=1e-7)

    vgg_pth, lin_pth = tmp_path / "vgg16.pth", tmp_path / "lin.pth"
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()
                if k.startswith("features.")}, vgg_pth)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()
                if k.startswith("lin")}, lin_pth)
    convert(str(vgg_pth), str(lin_pth), str(tmp_path / "lpips.npz"))
    model2 = LPIPS(LPIPS_STAGES)
    load_lpips_params(model2, str(tmp_path / "lpips.npz"))
    np.testing.assert_allclose(model2(a, b).numpy(), data["dist"],
                               atol=1e-5)


@pytest.mark.parametrize("S", [512, 300])
def test_resize_matches_jax(S):
    """The exact torch-bilinear LPIPS resize, vs lgm_tpu's and vs
    F.interpolate itself (f32 matmul order: 1e-5)."""
    from lgm_tpu.models.lgm import _resize_nchw_256 as jax_resize

    x = np.random.default_rng(S).uniform(-1, 1, (2, 3, S, S)).astype(
        np.float32)
    ours = _resize_nchw_256(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_resize(jnp.asarray(x))),
                               atol=1e-5)
    ref = torch.nn.functional.interpolate(torch.as_tensor(x), size=256,
                                          mode="bilinear",
                                          align_corners=False).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_synthetic_batch_matches_jax(nano_batch):
    """Same numpy stream: scenes, poses and cameras bit for bit; the GT
    renders (the port's flatsort vs lgm_tpu's oracle on the CPU) to the
    1e-3 flatsort is held to; the Plücker half of the input to 1e-5."""
    from lgm_tpu.data.synthetic import make_batch as jax_make_batch
    from lgm_tpu.utils import camera as jcamera
    from lgm_tpu_torch.data.synthetic import make_batch, sample_poses
    from lgm_tpu_torch.utils import camera

    jopt, _ = nano_batch
    opt = get_config("nano")
    jb = jax_make_batch(np.random.default_rng(3), jopt, batch_size=2,
                        n_gaussians=64)
    ours = make_batch(np.random.default_rng(3), opt, batch_size=2,
                      n_gaussians=64, device="cpu")
    np.testing.assert_array_equal(ours["scenes"], jb["scenes"])
    for key in ("cam_view", "cam_view_proj", "cam_pos"):
        np.testing.assert_array_equal(ours[key].numpy(), jb[key])
    for key in ("images_output", "masks_output"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(jb[key]),
                                   atol=1e-3, err_msg=key)
    inp, jinp = ours["input"].numpy(), np.asarray(jb["input"])
    np.testing.assert_allclose(inp[..., 3:], jinp[..., 3:], atol=1e-5)
    np.testing.assert_allclose(inp[..., :3], jinp[..., :3], atol=5e-3)
    poses = sample_poses(np.random.default_rng(9), opt)
    jposes = np.asarray(jcamera.canonicalize_poses(
        np.stack([jcamera.orbit_camera(10, a, 1.5) for a in (30, 120)]), 1.5))
    np.testing.assert_array_equal(camera.canonicalize_poses(
        np.stack([camera.orbit_camera(10, a, 1.5) for a in (30, 120)]), 1.5),
        jposes)
    assert poses.shape == (4, 4, 4)


@pytest.fixture(scope="module")
def nano_f32(nano_batch):
    """lgm_tpu's LGMWithLoss at nano, f32 compute, exact oracle renderer,
    LPIPS and the scale guard on; the port's on the converted weights."""
    from lgm_tpu.models.lgm import LGMWithLoss as JaxLGMWithLoss

    jopt, data = nano_batch
    jmodel = JaxLGMWithLoss(jopt, dtype=jnp.float32,
                            rasterizer_backend="xla")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    bg = jnp.asarray([0.3, 0.6, 0.9], jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jdata, bg)["params"]
    opt = get_config("nano").replace(lambda_lpips=1.0, lambda_scale_reg=0.5,
                                     mixed_precision="fp32")
    model = LGMWithLoss(opt, dtype=torch.float32, backend="reference")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           flax_params_to_state_dict(params).items()})
    return jopt, opt, jmodel, params, model, data, bg


def test_loss_and_grads_match_jax(nano_f32):
    """Every loss term and the gradient of every LGM parameter (through
    the U-Net, activations, the oracle renderer, MSE, scale guard and
    LPIPS) vs jax.grad of lgm_tpu's LGMWithLoss, f32: loss terms to 1e-5
    relative, each gradient to 1e-3 of its tensor's largest |value|
    (convolutions summed in other orders through 2 down, 2 up levels and
    cross-view attention) plus 1e-6, the f32 noise of gradients that are
    zero in exact arithmetic (a conv bias under GroupNorm)."""
    jopt, opt, jmodel, params, model, data, bg = nano_f32

    def loss_fn(p):
        out = jmodel.apply({"params": p}, {k: jnp.asarray(v)
                                           for k, v in data.items()}, bg)
        return out["loss"], out

    jgrads, jout = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    out = model(_torch_data(data), torch.as_tensor(np.asarray(bg)))
    out["loss"].backward()
    for key in ("loss", "loss_mse", "loss_lpips", "loss_reg", "psnr"):
        np.testing.assert_allclose(out[key].item(), float(jout[key]),
                                   rtol=1e-5, err_msg=key)
    ref = flax_params_to_state_dict({"lgm": jgrads["lgm"]})
    named = dict(model.named_parameters())
    assert set(ref) == {k for k, p in named.items() if p.requires_grad}
    for name, g in ref.items():
        ours = named[name].grad.numpy()
        np.testing.assert_allclose(ours, g, rtol=0,
                                   atol=1e-3 * np.abs(g).max() + 1e-6,
                                   err_msg=name)
    assert all(p.grad is None for p in model.lpips_loss.parameters())


def _find_adam_state(tree):
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (tuple, list)) else
                vars(tree).values() if hasattr(tree, "__dict__") else ())
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def test_train_step_matches_jax(nano_batch):
    """Two steps of lgm_tpu.train.train_step vs the port's from the same
    converted state, with the backgrounds JAX drew, f32 compute. Covers
    the clip (gnorm > 1), the schedule's first counts and the bf16 first
    moment. Adam's first step is g/|g| per element, so where a gradient is
    f32 noise (|g| near 0) the two sides may step opposite ways by up to
    lr: those elements (at most 0.1%) are held to 2·Σlr, every other to
    2e-7 + 1e-5 relative. Loss and gnorm: 1e-4 relative at step 0; 1e-3
    at step 1, after those flips. Adam's bf16 first moment to two bf16
    steps of its scale, the f32 second moment (a sum of g², twice the
    gradients' 1e-3 relative error) to 2e-3 of its scale, each plus the
    floor of gradients that are f32 noise (1e-6 in the gradient)."""
    from lgm_tpu.train import create_state as jax_create_state
    from lgm_tpu.train import train_step as jax_train_step

    jopt, data = nano_batch
    jopt = jopt.replace(mixed_precision="fp32")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jstate, _ = jax_create_state(jopt, jax.random.PRNGKey(0), jdata,
                                 backend="xla")
    opt = get_config("nano").replace(lambda_lpips=1.0, lambda_scale_reg=0.5,
                                     mixed_precision="fp32")
    state = train.create_state(opt, "cpu", backend="reference")
    state.model.load_state_dict({k: torch.as_tensor(v) for k, v in
                                 flax_params_to_state_dict(
                                     jstate.params).items()})
    tdata = _torch_data(data)
    step = jax.jit(jax_train_step)
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        bg = np.asarray(jax.random.uniform(key, (3,)))
        jstate, jm = step(jstate, jdata, key)
        m = train.train_step(state, tdata, torch.tensor(bg))
        for k in ("loss", "loss_mse", "loss_lpips", "loss_reg", "gnorm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-4 if i == 0 else 1e-3,
                                       err_msg=f"step {i} {k}")
        assert float(jm["gnorm"]) > opt.gradient_clip  # the clip is active
    assert state.step == 2 and state.optimizer.count == 2
    lr_sum = train.current_lr(opt, 0) + train.current_lr(opt, 1)
    ref = flax_params_to_state_dict({"lgm": jstate.params["lgm"]})
    named = dict(state.model.named_parameters())
    n_flip = n_all = 0
    for name, p in ref.items():
        ours = named[name].detach().numpy()
        close = np.isclose(ours, p, rtol=1e-5, atol=2e-7)
        assert np.all(np.abs(ours - p)[~close] <= 2 * lr_sum), name
        n_flip += int((~close).sum())
        n_all += close.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)
    adam = _find_adam_state(jstate.opt_state)
    mu = flax_params_to_state_dict({"lgm": jax.tree.map(
        lambda x: np.asarray(x, np.float32), adam.mu["lgm"])})
    nu = flax_params_to_state_dict({"lgm": adam.nu["lgm"]})
    names = [n for n, _ in state.model.lgm.named_parameters()]
    for n, m_, v_ in zip(names, state.optimizer.mu, state.optimizer.nu):
        assert m_.dtype == torch.bfloat16
        jm_, jv_ = mu["lgm." + n], nu["lgm." + n]
        np.testing.assert_allclose(m_.float().numpy(), jm_, rtol=0,
                                   atol=2 ** -7 * np.abs(jm_).max() + 1e-7,
                                   err_msg=n)
        np.testing.assert_allclose(v_.numpy(), jv_, rtol=0,
                                   atol=2e-3 * np.abs(jv_).max() + 1e-13,
                                   err_msg=n)


@pytest.mark.parametrize("k_steps", [1, 2])
def test_optimizer_matches_optax(k_steps):
    """The port's Optimizer vs lgm_tpu's optax chain under jit, as
    lgm_tpu's train step runs it (clip 1.0, AdamW with a bf16 first
    moment, the one-cycle schedule, MultiSteps at k=2), on a small
    parameter set over 6 steps whose gradient norms fall on both sides of
    the clip: to f32 rounding (1e-6 relative)."""
    from lgm_tpu.train import make_optimizer as jax_make_optimizer

    jopt = jax_get_config("nano").replace(
        warmup_steps=2, total_steps=5, lr=1e-2,
        gradient_accumulation_steps=k_steps)
    opt = get_config("nano").replace(
        warmup_steps=2, total_steps=5, lr=1e-2,
        gradient_accumulation_steps=k_steps)
    rng = np.random.default_rng(k_steps)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 3), (5,))]
    tx = jax_make_optimizer(jopt)
    jp = {"lgm": {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}}
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.as_tensor(x.copy())) for x in p0]
    ours = train.Optimizer(params, opt)
    for i in range(6):
        scale = 3.0 if i % 2 == 0 else 0.05
        g = [rng.normal(0, scale, x.shape).astype(np.float32) for x in p0]
        upd, jstate = jax.jit(tx.update)(
            {"lgm": {"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}},
            jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ours.update([torch.as_tensor(x) for x in g])
        for a, b in zip(params, (jp["lgm"]["a"], jp["lgm"]["b"])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")


def test_current_lr_matches_optax():
    opt = get_config("nano").replace(warmup_steps=30, total_steps=200,
                                     lr=4e-4)
    sched = optax.cosine_onecycle_schedule(
        transition_steps=200, peak_value=4e-4, pct_start=30 / 200,
        div_factor=25.0, final_div_factor=1e4)
    for step in (0, 29, 30, 115, 200, 250):
        np.testing.assert_allclose(train.current_lr(opt, step),
                                   float(sched(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_unet_remat_changes_no_number():
    """U-Net block recompute (unet_remat) changes memory only: the same
    loss and bit-identical gradients at nano, f32, on the CPU."""
    from lgm_tpu_torch.models.lgm import LGM

    opt = get_config("nano").replace(mixed_precision="fp32")
    x = torch.as_tensor(np.random.default_rng(4).normal(
        0, 1, (1, 2, 32, 32, 9)).astype(np.float32))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = LGM(opt.replace(unet_remat=remat), dtype=torch.float32)
        assert model.unet.remat == remat
        model(x).square().mean().backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cli_flags_match_jax():
    """The trainer's flags parse to the same Options as lgm_tpu's CLI."""
    import dataclasses

    from lgm_tpu.config import parse_cli as jax_parse_cli
    from lgm_tpu_torch.config import parse_cli

    argv = ["big", "--batch-size", "2", "--lambda-lpips", "0.5",
            "--resume", "auto", "--down-channels", "32,64,96",
            "--unet-remat", "false", "--total-steps", "7",
            "--rasterizer-dup", "16", "--eval-only", "true"]
    assert dataclasses.asdict(parse_cli(argv)) == dataclasses.asdict(
        jax_parse_cli(argv))


def test_loss_falls_on_flatsort_path():
    """A few steps on one fixed nano batch through the port's flatsort
    path (K2 and K2ᵇ's plain versions on the CPU), bf16 compute as
    trained: the loss falls clearly."""
    from lgm_tpu_torch.data.synthetic import make_batch

    opt = get_config("nano")
    state = train.create_state(opt, "cpu")
    batch = make_batch(np.random.default_rng(0), opt, batch_size=2,
                       n_gaussians=64, device="cpu")
    data = {k: v for k, v in batch.items() if k != "scenes"}
    gen = torch.Generator().manual_seed(1)
    losses = [float(train.train_step(state, data, torch.rand(
        3, generator=gen))["loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < 0.9 * np.mean(losses[:2]), losses


def test_checkpoint_roundtrip(tmp_path):
    from lgm_tpu_torch.data.synthetic import make_batch

    opt = get_config("nano")
    state = train.create_state(opt, "cpu")
    batch = make_batch(np.random.default_rng(1), opt, batch_size=2,
                       n_gaussians=32, device="cpu")
    data = {k: v for k, v in batch.items() if k != "scenes"}
    train.train_step(state, data, torch.ones(3))
    path = train.save_checkpoint(str(tmp_path), state, step=1)
    assert train.latest_checkpoint(str(tmp_path)) == path
    state2 = train.load_checkpoint(path, train.create_state(opt, "cpu",
                                                            seed=7))
    assert state2.step == 1 and state2.optimizer.count == 1
    for (n, a), b in zip(state.model.state_dict().items(),
                         state2.model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    state2.optimizer.mu + state2.optimizer.nu):
        assert torch.equal(a, b)


def _cli_env(tmp_path):
    """The CLI subprocesses' environment: one OpenMP thread (see
    torch_threads.py), and a ``tensorboard`` package that fails to import,
    so MetricLogger takes its JSONL-only path (where TensorFlow is
    installed, TensorBoard imports it: ~10 s of start-up per process).
    test_eval_cadence_profile_and_eval_only covers the TensorBoard mirror
    in-process."""
    shim = tmp_path / "no_tensorboard" / "tensorboard"
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('tensorboard hidden from this test')\n")
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([str(shim.parent), ROOT]))


def _run_cli(args, env):
    return subprocess.run(
        [sys.executable, "-u", "-m", "lgm_tpu_torch.train", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)


def test_cli_runs_on_cpu_and_needs_a_card_by_default(tmp_path):
    ws = str(tmp_path / "ws")
    proc = _run_cli(["nano", "--device", "cpu", "--workspace", ws,
                     "--total-steps", "2", "--eval-every", "1"],
                    _cli_env(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    evals = [int(l.split()[2].rstrip(":")) for l in proc.stdout.splitlines()
             if l.startswith("eval @ ")]
    assert evals == [1, 2], proc.stdout
    assert os.path.exists(os.path.join(ws, "ckpt_2"))
    assert os.path.getsize(os.path.join(ws, "metrics.jsonl")) > 0
    assert not os.path.exists(os.path.join(ws, "tb"))  # JSONL only
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["nano", "--workspace", ws, "--total-steps", "1"])
    # vp > 1 needs a world of several processes (torchrun); alone, main
    # refuses it before any work.
    with pytest.raises(ValueError, match="vp=2"):
        train.main(["nano", "--device", "cpu", "--workspace", ws,
                    "--total-steps", "1", "--vp", "2"])


def test_eval_cadence_profile_and_eval_only(tmp_path, capsys):
    """In-process main(): eval_every drives the eval/checkpoint cadence
    (plus the final step), the scalars go to metrics.jsonl and to
    TensorBoard (where it imports), --profile-steps writes a
    torch.profiler trace of steps [10, 10 + N), and --eval-only after
    --resume auto evaluates the restored state and exits."""
    ws = str(tmp_path / "ws")
    train.main(["nano", "--device", "cpu", "--workspace", ws,
                "--total-steps", "12", "--eval-every", "5",
                "--profile-steps", "1"])
    out = capsys.readouterr().out
    evals = [int(l.split()[2].rstrip(":")) for l in out.splitlines()
             if l.startswith("eval @ ")]
    assert evals == [5, 10, 12], out
    with open(os.path.join(ws, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    assert [r["step"] for r in records if "eval/loss" in r] == [5, 10, 12]
    try:
        import torch.utils.tensorboard  # noqa: F401
    except Exception:
        pass  # no TensorBoard on this host: JSONL only
    else:
        assert any(name.startswith("events.out.tfevents")
                   for name in os.listdir(os.path.join(ws, "tb")))
    assert os.path.getsize(os.path.join(ws, "trace", "trace.json")) > 0
    assert train.latest_checkpoint(ws) == os.path.abspath(
        os.path.join(ws, "ckpt_12"))
    emeans = train.main(["nano", "--device", "cpu", "--workspace", ws,
                         "--resume", "auto", "--eval-only", "true"])
    assert set(emeans) == {"loss", "psnr"} and np.isfinite(
        list(emeans.values())).all()


def test_preemption_save_and_auto_resume(tmp_path):
    """SIGTERM mid-training saves a full-state checkpoint after the
    in-flight step and exits cleanly; ``--resume auto`` continues from
    it."""
    ws = str(tmp_path / "ws")
    env = _cli_env(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "lgm_tpu_torch.train", "nano",
         "--device", "cpu", "--workspace", ws, "--total-steps", "100000"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        deadline = time.time() + 240
        saw_step = False
        for line in proc.stdout:
            if line.startswith("step 1:"):
                saw_step = True
                break
            if time.time() > deadline:
                break
        assert saw_step, "training never reached step 1"
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()
        rc = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, out
    assert "preemption save" in out, out
    ckpt = train.latest_checkpoint(ws)
    assert ckpt is not None
    saved = int(os.path.basename(ckpt).split("_")[1])
    resumed = _run_cli(["nano", "--device", "cpu", "--workspace", ws,
                        "--resume", "auto", "--total-steps",
                        str(saved + 1)], env)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert f"auto-resuming from {ckpt}" in resumed.stdout
    assert f"eval @ {saved + 1}:" in resumed.stdout
