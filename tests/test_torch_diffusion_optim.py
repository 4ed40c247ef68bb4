"""The port's diffusion finetune on the CPU, apart from the f32 twins of
test_torch_diffusion_train*.py: the finetune's optimizer chain and
schedule against jitted optax, the bf16 step against lgm_tpu's, the
initialisation of from_config (repair R2: lgm_tpu's zeros, so the loss at
init is E||ε||² ≈ 1), the EMA's decay, the dp slices of prepare_batch,
save -> restore, and the export -> from_pretrained round trip.

Tolerances: the optimizer to f32 rounding (1e-6 relative, as
test_torch_train.py::test_optimizer_matches_optax); the schedule to 1e-6
relative. The bf16 step: both sides round the U-Net's activations to bf16
at different points, so loss and gradient norm agree to 5e-3 relative
(measured: 4e-4 to 8e-4) and the U-Net gradients to a relative RMS error
over all leaves of 2^-5 (measured 0.018), the tolerance chip_smoke.py
holds the K1 route to against dense."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from diffusion_twins import host_batch, run_grads, twin_trainers
from lgm_tpu.diffusion import pipeline as jpipe
from lgm_tpu.diffusion.train import make_optimizer as jax_make_optimizer
from lgm_tpu_torch.diffusion import pipeline as tpipe
from lgm_tpu_torch.diffusion import train as dtrain
from lgm_tpu_torch.diffusion.mv_unet import zero_init_modules
from lgm_tpu_torch.parallel import dist
from lgm_tpu_torch.weights import diffusion_params_to_state_dicts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("warmup", [3, 0])
def test_warmup_schedule_matches_optax(warmup):
    n = max(warmup, 1)
    ref = optax.join_schedules([optax.linear_schedule(0.0, 3e-4, n),
                                optax.constant_schedule(3e-4)], [n])
    ours = dtrain.warmup_constant(3e-4, warmup)
    assert ours(0) == 0.0
    for count in range(7):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, err_msg=str(count))


def test_finetune_optimizer_matches_optax():
    """The port's finetune chain vs lgm_tpu's make_optimizer under jit
    (clip 1.0, warmup 3, b2 0.999, weight decay 0.01, a bf16 first
    moment) over 5 steps whose gradient norms fall on both sides of the
    clip; the first update, at lr 0, leaves the parameters unchanged."""
    rng = np.random.default_rng(0)
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in ((4, 3), (5,))]
    tx = jax_make_optimizer(1e-2, 3, 5, 1.0)
    jp = {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.as_tensor(x.copy())) for x in p0]
    ours = dtrain.make_optimizer(params, 1e-2, 3, 1.0)
    update = jax.jit(tx.update)
    for i in range(5):
        scale = 3.0 if i % 2 == 0 else 0.05
        g = [rng.normal(0, scale, x.shape).astype(np.float32) for x in p0]
        upd, jstate = update({"a": jnp.asarray(g[0]),
                              "b": jnp.asarray(g[1])}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ours.update([torch.as_tensor(x) for x in g])
        for a, b in zip(params, (jp["a"], jp["b"])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")
        if i == 0:
            for a, b in zip(params, p0):
                np.testing.assert_array_equal(a.detach().numpy(), b)
    for m, ref in zip(ours.mu, (jstate[1][0].mu["a"], jstate[1][0].mu["b"])):
        assert m.dtype == torch.bfloat16
        # bf16 values rounded from f32 sums that may differ in the last
        # bits: one bf16 step.
        np.testing.assert_allclose(m.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=2 ** -8)


def test_bf16_step_matches_lgm_tpu():
    """The published configs' bf16 compute, at tiny-test: one step from
    one state on the same batch (tolerances in the module docstring)."""
    jt, tt = twin_trainers("tiny-test", compute_dtype="bfloat16")
    data = host_batch(np.random.default_rng(1))
    loss, jloss, grads, ref = run_grads(jt, tt, data)
    np.testing.assert_allclose(loss, jloss, rtol=5e-3)
    num = sum(float(((grads[n] - g) ** 2).sum()) for n, g in ref.items())
    den = sum(float((g ** 2).sum()) for g in ref.values())
    assert np.sqrt(num / den) <= 2.0 ** -5, np.sqrt(num / den)
    jt.rng, tt.rng = np.random.default_rng(0), np.random.default_rng(0)
    jm, tm = jt.train_step(data), tt.train_step(data)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=5e-3,
                                   err_msg=k)


def test_from_config_zeros_are_lgm_tpus():
    """R2: the port's from_config U-Net holds exactly the zero leaves of
    lgm_tpu's (every bias, and the weights of each SpatialTransformer's
    proj_out, each ResBlock's out conv and the final out conv)."""
    params = jpipe.MVDreamPipeline.from_config("tiny-test-ip").params
    ref = diffusion_params_to_state_dicts(
        {"unet": jax.tree.map(np.asarray, params["unet"])})["unet"]
    pipe = tpipe.MVDreamPipeline.from_config("tiny-test-ip", device="cpu")
    ours = {k: v.numpy() for k, v in pipe.unet.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    zeros = sorted(k for k, v in ours.items() if not v.any())
    assert zeros == sorted(k for k, v in ref.items() if not v.any())
    assert all(not m.weight.any() for m in zero_init_modules(pipe.unet))
    assert len(zero_init_modules(pipe.unet)) == 16


def test_loss_at_init_is_unit_noise():
    """The twin of lgm_tpu's test: from_config's U-Net predicts ε = 0, so
    the first loss is E||ε||² ≈ 1."""
    pipe = tpipe.MVDreamPipeline.from_config("tiny-test", device="cpu")
    tr = dtrain.DiffusionTrainer(pipe, lr=2e-3, warmup=1, cond_drop=0.0)
    m = tr.train_step(host_batch(np.random.default_rng(0), B=4, S=32))
    assert 0.85 < float(m["loss"]) < 1.15
    assert np.isfinite(float(m["gnorm"]))


def test_ema_decay_ramp_and_no_shadow():
    for s in (0, 1, 5, 100, 10 ** 6):
        want = np.minimum(np.float32(0.9999),
                          np.float32(1 + s) / np.float32(10 + s))
        assert dtrain.ema_decay_at(0.9999, s) == float(want)
    pipe = tpipe.MVDreamPipeline.from_config("tiny-test", device="cpu")
    tr = dtrain.DiffusionTrainer(pipe, ema_decay=0.0)
    assert tr.ema is None and "ema" not in tr.state_dict()


def test_prepare_batch_dp_slices_are_the_global_batch():
    """Each dp rank draws the whole batch's noise, t and dropout and
    encodes its own scenes: the ranks' slices, joined, are the one-process
    batch (the draws bit for bit). A batch that does not split over dp is
    refused."""
    data = host_batch(np.random.default_rng(2), B=4)
    pipe = tpipe.MVDreamPipeline.from_config("tiny-test-ip", device="cpu")
    one = dtrain.DiffusionTrainer(pipe, cond_drop=0.5).prepare_batch(data)
    parts = [dtrain.DiffusionTrainer(
        pipe, cond_drop=0.5, world=dist.World(rank=r, size=2))
        .prepare_batch(data) for r in range(2)]
    for k, v in one.items():
        joined = torch.cat([p[k] for p in parts])
        if k in ("noise", "t", "camera"):
            assert torch.equal(joined, v), k
        else:
            torch.testing.assert_close(joined, v, rtol=0,
                                       atol=1e-6 * v.abs().max().item())
    with pytest.raises(AssertionError, match="not divisible"):
        dtrain.DiffusionTrainer(pipe, world=dist.World(rank=0, size=2)) \
            .prepare_batch(host_batch(np.random.default_rng(2), B=3))


def _equal_states(a, b):
    assert a["step"] == b["step"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    for key in ("unet", "ema"):
        assert sorted(a[key]) == sorted(b[key])
        for n, v in a[key].items():
            assert torch.equal(v, b[key][n]), (key, n)
    for key in ("mu", "nu"):
        for n, v in a["opt_state"][key].items():
            assert torch.equal(v, b["opt_state"][key][n]), (key, n)


def test_save_restore_and_export(tmp_path):
    """save -> restore in a fresh trainer gives the same state, and the
    same next step; export writes the EMA U-Net (the raw one with
    use_ema=False) beside the frozen encoders, which from_pretrained reads
    back bit for bit."""
    cfg = dataclasses.replace(tpipe.CONFIGS["tiny-test"],
                              compute_dtype="float32")

    def trainer():
        torch.manual_seed(0)
        return dtrain.DiffusionTrainer(tpipe.MVDreamPipeline(cfg, "cpu"),
                                       lr=1e-3, warmup=1)

    tr = trainer()
    data = host_batch(np.random.default_rng(3))
    for _ in range(2):
        tr.train_step(data)
    path = tr.save(str(tmp_path / "ws"))
    assert path.endswith("dckpt_2")
    back = trainer()
    back.restore(path)
    _equal_states(back.state_dict(), tr.state_dict())
    tr.rng, back.rng = np.random.default_rng(4), np.random.default_rng(4)
    assert torch.equal(tr.train_step(data)["loss"],
                       back.train_step(data)["loss"])
    _equal_states(back.state_dict(), tr.state_dict())

    for use_ema in (True, False):
        out = str(tmp_path / f"export_{use_ema}")
        tr.export(out, use_ema=use_ema)
        pipe = tpipe.MVDreamPipeline.from_pretrained(out, device="cpu")
        want = dict(zip(tr.names, tr.ema)) if use_ema else \
            dict(tr.unet.named_parameters())
        got = pipe.unet.state_dict()
        assert sorted(got) == sorted(want)
        for n, v in want.items():
            assert torch.equal(got[n], v.detach()), n
        assert torch.equal(pipe.vae.encoder.conv_in.weight,
                           tr.pipe.vae.encoder.conv_in.weight)
    assert not all(torch.equal(e, p) for e, p in
                   zip(tr.ema, tr.unet.parameters()))
