"""Shared by the port's diffusion finetune tests: lgm_tpu's
DiffusionTrainer and the port's on one state, the batches they take, and
the comparisons of their states (imported by each test module)."""

import dataclasses
import importlib.util
import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.diffusion import pipeline as jpipe
from lgm_tpu.diffusion.train import DiffusionTrainer as JaxTrainer
from lgm_tpu.diffusion.train import diffusion_loss as jax_loss
from lgm_tpu_torch.diffusion import pipeline as tpipe
from lgm_tpu_torch.diffusion.data import blender_condition
from lgm_tpu_torch.diffusion.train import DiffusionTrainer, diffusion_loss
from lgm_tpu_torch.diffusion.vae import SCALING_FACTOR
from lgm_tpu_torch.weights import (_adam_state,
                                   diffusion_params_to_state_dicts,
                                   diffusion_train_state_to_torch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def host_batch(rng, B=2, F=4, S=16):
    """A host batch in the datasets' contract, small enough for the tiny
    VAE (16² images -> 8² latents)."""
    return {
        "images": rng.uniform(0, 1, (B, F, S, S, 3)).astype(np.float32),
        "camera": np.stack([
            np.stack([blender_condition(rng.uniform(-10, 30), a)
                      for a in rng.uniform(0, 360) + 90.0 * np.arange(F)])
            for _ in range(B)]).astype(np.float32),
        "prompts": [f"a test object {i}" for i in range(B)],
    }


def _fill_zeros(tree, rng):
    """The tree with every all-zero leaf (lgm_tpu's zero-initialised
    output layers and its biases) drawn from N(0, 0.05²): gradients then
    reach every layer from the first step."""
    return jax.tree.map(
        lambda x: (rng.normal(0, 0.05, x.shape).astype(np.float32)
                   if not np.any(x) else np.asarray(x, np.float32)), tree)


def jax_state(jt):
    return {"unet": jax.device_get(jt.params),
            "opt_state": jax.device_get(jt.opt_state),
            "ema": (None if jt.ema_params is None
                    else jax.device_get(jt.ema_params)),
            "step": jt.step}


def twin_trainers(name, compute_dtype="float32", lr=1e-3, warmup=1,
                  cond_drop=0.5, seed=0, ema_decay=0.9999):
    """lgm_tpu's trainer at config ``name`` in ``compute_dtype`` on
    lgm_tpu's from_config parameters (zero leaves of the U-Net filled),
    and the port's trainer started from lgm_tpu's state, carried across
    by ``diffusion_train_state_to_torch`` (the frozen encoders by
    ``diffusion_params_to_state_dicts``)."""
    params = jax.tree.map(np.asarray, jpipe.MVDreamPipeline.from_config(
        name).params)
    params["unet"] = _fill_zeros(params["unet"], np.random.default_rng(9))
    jp = jpipe.MVDreamPipeline(dataclasses.replace(
        jpipe.CONFIGS[name], compute_dtype=compute_dtype), params=params)
    kw = dict(lr=lr, warmup=warmup, cond_drop=cond_drop, seed=seed,
              ema_decay=ema_decay)
    jt = JaxTrainer(jp, num_devices=1, total_steps=100, **kw)
    tp = tpipe.MVDreamPipeline(dataclasses.replace(
        tpipe.CONFIGS[name], compute_dtype=compute_dtype), device="cpu")
    tp.load_state_dicts(diffusion_params_to_state_dicts(
        {k: params[k] for k in tp.modules()}))
    tt = DiffusionTrainer(tp, **kw)
    tt.load_state_dict(diffusion_train_state_to_torch(jax_state(jt)))
    return jt, tt


def jax_unet_sd(tree, dtype=np.float32):
    """An lgm_tpu U-Net tree (parameters, a moment, gradients) under the
    port's names."""
    return diffusion_params_to_state_dicts({"unet": jax.tree.map(
        lambda x: np.asarray(x, dtype), tree)})["unet"]


def batch_to_jax_layout(batch):
    """The port's prepared batch (NCHW, torch) in lgm_tpu's layout."""
    out = {}
    for k, v in batch.items():
        x = v.detach().cpu().numpy()
        if k in ("latents", "noise"):
            x = x.transpose(0, 1, 3, 4, 2)
        elif k == "ip_img":
            x = x.transpose(0, 2, 3, 1)
        out[k] = x
    return out


def assert_params_close(ours, ref, lr_sum, what):
    """Parameters (or their EMA) after Adam steps: 1e-5 relative + 2e-7 +
    Σlr / 4, except where a gradient is f32 noise and Adam's g/|g| may
    turn either way: at most 0.1% of the elements, each within 2 Σlr.
    (Adam scales each element's step to about lr, so an element whose
    gradient the two sides compute to a relative error e, large where it
    is small beside its leaf's, or whose bf16 first moment rounds to the
    other neighbour, steps e·lr apart: at most 0.1 lr at the tiny
    configs.)"""
    n_flip = n_all = 0
    assert set(ours) == set(ref), what
    for name, p in ref.items():
        q = np.asarray(ours[name], np.float32)
        close = np.abs(q - p) <= 1e-5 * np.abs(p) + 2e-7 + lr_sum / 4
        assert np.all(np.abs(q - p)[~close] <= 2 * lr_sum), (what, name)
        n_flip += int((~close).sum())
        n_all += close.size
    assert n_flip <= 1e-3 * n_all, (what, n_flip, n_all)


def torch_sd(named):
    return {k: v.detach().float().cpu().numpy() for k, v in named.items()}


def _grads(jt, tt, jb, tb):
    """The U-Net gradients of one loss on each side's prepared batch
    (lgm_tpu's under the port's names), and the two losses."""
    table = jnp.asarray(jt.pipe.scheduler.alphas_cumprod, jnp.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss(jt.pipe.unet, p, b, table, tt.ip)))(
        jt.params, {k: jnp.asarray(v) for k, v in jb.items()})
    loss = diffusion_loss(tt.unet, tb, tt.alphas_cumprod, tt.ip)
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in tt.unet.named_parameters()}
    for p in tt.unet.parameters():
        p.grad = None
    return loss.item(), float(jl), grads, jax_unet_sd(jg)


def run_grads(jt, tt, data):
    """prepare_batch on each side, then ``_grads``."""
    jb = {k: np.asarray(v) for k, v in jt.prepare_batch(data).items()}
    return _grads(jt, tt, jb, tt.prepare_batch(data))


def run_twins(name, cond_drop, tmp=None):
    """Everything the module's tests check, in one pass (the trainers are
    stateful): prepare_batch on each side, the gradients, two steps from
    the same seed, and (given ``tmp``) lgm_tpu's checkpoint through
    scripts/dckpt_to_torch.py into a fresh port trainer, one more step
    on each side."""
    jt, tt = twin_trainers(name, cond_drop=cond_drop, lr=LR)
    data = host_batch(np.random.default_rng(1))
    out = {"data": data, "trainer": tt, "jax_trainer": jt}
    out["jb"] = {k: np.asarray(v) for k, v in jt.prepare_batch(data).items()}
    out["tb"] = tt.prepare_batch(data)
    out["losses"] = _grads(jt, tt, out["jb"], out["tb"])
    jt.rng, tt.rng = np.random.default_rng(0), np.random.default_rng(0)
    out["steps"] = [(jt.train_step(data), tt.train_step(data))
                    for _ in range(2)]
    out["jax_state"], out["state"] = jax_state(jt), tt.state_dict()
    if tmp is not None:
        path = jt.save(str(tmp / "jax_ws"))
        spec = importlib.util.spec_from_file_location(
            "dckpt_to_torch", os.path.join(ROOT, "scripts",
                                           "dckpt_to_torch.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        conv = script.main(["--pipeline", name, "--dckpt", path,
                            "--out", str(tmp / "torch_ws" / "dckpt_2")])
        tp = tpipe.MVDreamPipeline(tt.pipe.cfg, device="cpu")
        tp.load_state_dicts({k: m.state_dict() for k, m in
                             tt.pipe.modules().items() if k != "unet"})
        fresh = DiffusionTrainer(tp, lr=LR, warmup=1, cond_drop=cond_drop)
        fresh.restore(conv)
        out["restored_step"] = fresh.step
        data3 = host_batch(np.random.default_rng(3))
        jt.rng, fresh.rng = np.random.default_rng(5), np.random.default_rng(5)
        out["step3"] = (jt.train_step(data3), fresh.train_step(data3))
        out["jax_state3"], out["state3"] = jax_state(jt), fresh.state_dict()
    return out


def check_prepare_batch(run):
    """The port's batch in lgm_tpu's layout: host draws bit for bit, the
    encoders' output to f32 rounding; the latents are the VAE posterior
    sampled with the seed's first draw, NHWC, moved to NCHW."""
    tb, jb = batch_to_jax_layout(run["tb"]), run["jb"]
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].shape == jb[k].shape, k
        if k in ("latents", "context", "ip_feats", "ip_img"):
            np.testing.assert_allclose(
                tb[k], jb[k], rtol=0, atol=1e-5 * np.abs(jb[k]).max(),
                err_msg=k)
        else:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    tt, images = run["trainer"], run["data"]["images"]
    B, F, S = images.shape[:3]
    h = S // 2 ** (len(tt.pipe.cfg.vae_channels) - 1)
    eps = np.random.default_rng(0).standard_normal(
        (B * F, h, h, 4)).astype(np.float32)
    with torch.no_grad():
        mean, logvar = tt.pipe.vae.encode(torch.as_tensor(
            np.ascontiguousarray(images.reshape(B * F, S, S, 3)
                                 .transpose(0, 3, 1, 2))) * 2.0 - 1.0)
    want = (mean + torch.exp(0.5 * logvar)
            * torch.as_tensor(np.ascontiguousarray(eps.transpose(0, 3, 1, 2)))
            ) * SCALING_FACTOR
    assert torch.equal(run["tb"]["latents"].reshape(want.shape), want)


def check_gradients(run):
    loss, jloss, grads, ref = run["losses"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert sorted(grads) == sorted(ref)
    scale = max(np.abs(g).max() for g in ref.values())
    assert scale > 1e-2
    for n, g in ref.items():
        np.testing.assert_allclose(grads[n], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-7,
                                   err_msg=n)


def check_states(state, jstate, lr_sum, what):
    """The port's trainer state against lgm_tpu's: parameters and EMA,
    Adam's count and moments, the step."""
    assert_params_close(torch_sd(state["unet"]), jax_unet_sd(jstate["unet"]),
                        lr_sum, what + " params")
    assert_params_close(torch_sd(state["ema"]), jax_unet_sd(jstate["ema"]),
                        lr_sum, what + " ema")
    adam = _adam_state(jstate["opt_state"])
    assert state["opt_state"]["count"] == int(adam.count)
    assert state["step"] == jstate["step"]
    mu, nu = jax_unet_sd(adam.mu), jax_unet_sd(adam.nu)
    for n, ref in mu.items():
        ours = state["opt_state"]["mu"][n]
        assert ours.dtype == torch.bfloat16, n
        np.testing.assert_allclose(
            ours.float().numpy(), ref, rtol=0,
            atol=2 ** -7 * np.abs(ref).max() + 1e-7, err_msg=n)
    for n, ref in nu.items():
        np.testing.assert_allclose(
            state["opt_state"]["nu"][n].numpy(), ref, rtol=0,
            atol=1e-4 * np.abs(ref).max() + 1e-13, err_msg=n)


def check_steps(run):
    """Two steps: loss and gnorm each step; the first at lr 0 leaves the
    parameters unchanged; then every part of the state."""
    for i, (jm, tm) in enumerate(run["steps"]):
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    check_states(run["state"], run["jax_state"], LR, "after 2 steps")
