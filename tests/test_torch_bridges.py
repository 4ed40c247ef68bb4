"""The bridges from lgm_tpu's own files into the port's, at nano and
tiny-test sizes on the CPU: a trainer checkpoint ``ckpt_N``
(``scripts/ckpt_to_torch.py``) from which the port's next step is
lgm_tpu's, a pipeline directory (``scripts/pipeline_to_torch.py``) whose
converted views are lgm_tpu's, and the LPIPS weights converter
(``lgm_tpu_torch.tools.convert_lpips``), whose ``.npz`` is lgm_tpu's."""

import dataclasses
import importlib.util
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from diffusion_twins import _fill_zeros
from lgm_tpu import train as jtrain
from lgm_tpu.config import get_config as jax_get_config
from lgm_tpu.diffusion import pipeline as jpipe
from lgm_tpu.models.lpips import LPIPS as JaxLPIPS
from lgm_tpu.models.lpips import load_lpips_params as jax_load_lpips
from lgm_tpu.tools import convert_lpips as jconvert_lpips
from lgm_tpu_torch import train, weights
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.diffusion import pipeline as tpipe
from lgm_tpu_torch.models.lgm import LGM
from lgm_tpu_torch.models.lpips import LPIPS, load_lpips_params
from lgm_tpu_torch.tools import convert_lpips
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "clip_tokenizer")
FLAGS = ["nano", "--lambda-lpips", "1.0", "--lambda-scale-reg", "0.5",
         "--mixed-precision", "fp32"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _find_adam_state(tree):
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def _lgm_names(opt):
    with torch.device("meta"):
        return [n for n, _ in LGM(opt).named_parameters()]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """lgm_tpu at nano (f32, LPIPS and the scale guard on, the exact
    renderer): its state after one train step, saved as ``ckpt_1`` by its
    own ``save_checkpoint``, and the port's conversion of that file."""
    from lgm_tpu.data.synthetic import make_batch

    jopt = jax_get_config("nano").replace(
        lambda_lpips=1.0, lambda_scale_reg=0.5, mixed_precision="fp32")
    batch = make_batch(np.random.default_rng(0), jopt, batch_size=2,
                       n_gaussians=64)
    data = {k: np.asarray(v) for k, v in batch.items() if k != "scenes"}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jstate, _ = jtrain.create_state(jopt, jax.random.PRNGKey(0), jdata,
                                    backend="xla")
    step = jax.jit(jtrain.train_step)
    jstate, _ = step(jstate, jdata, jax.random.PRNGKey(10))
    tmp = tmp_path_factory.mktemp("bridge")
    src = jtrain.save_checkpoint(str(tmp / "jax"), jstate, 1)
    path = _script("ckpt_to_torch").main(
        [*FLAGS, "--ckpt", src, "--out", str(tmp / "torch")])
    return jstate, jdata, step, path


def test_ckpt_to_torch_next_step_matches_jax(jax_run):
    """The converted ``ckpt_1`` read by the trainer's resume
    (``train.load_checkpoint``): parameters and Adam's state bit for bit
    (the first moment bf16, ROADMAP C4), then the port's next step against
    lgm_tpu's from its checkpointed state, with the background JAX drew,
    at ``test_train_step_matches_jax``'s tolerances: loss terms and gnorm
    to 1e-4 relative; parameters to 2e-7 + 1e-5 relative, except Adam's
    noise-level flips (at most 0.1%, each within 2 lr); the first moment
    to two bf16 steps of its scale, the second to 2e-3 of its."""
    jstate, jdata, step, path = jax_run
    opt = get_config("nano").replace(lambda_lpips=1.0, lambda_scale_reg=0.5,
                                     mixed_precision="fp32")
    state = train.load_checkpoint(
        path, train.create_state(opt, "cpu", backend="reference"))
    assert state.step == 1 and state.optimizer.count == 1
    names = [n for n, _ in state.model.lgm.named_parameters()]
    adam = _find_adam_state(jstate.opt_state)
    ref = weights.flax_params_to_state_dict(jax.device_get(jstate.params))
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    for moment, dtype in (("mu", torch.bfloat16), ("nu", torch.float32)):
        want = weights.flax_params_to_state_dict({"lgm": jax.tree.map(
            lambda x: np.asarray(x, np.float32),
            getattr(adam, moment)["lgm"])})
        for n, t in zip(names, getattr(state.optimizer, moment)):
            assert t.dtype == dtype
            np.testing.assert_array_equal(t.float().numpy(),
                                          want["lgm." + n], err_msg=n)

    key = jax.random.PRNGKey(11)
    bg = np.asarray(jax.random.uniform(key, (3,)))
    jstate, jm = step(jstate, jdata, key)
    m = train.train_step(state, {k: torch.tensor(np.asarray(v))
                                 for k, v in jdata.items()},
                         torch.tensor(bg))
    for k in ("loss", "loss_mse", "loss_lpips", "loss_reg", "gnorm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    lr = train.current_lr(opt, 1)
    ref = weights.flax_params_to_state_dict({"lgm": jstate.params["lgm"]})
    named = dict(state.model.named_parameters())
    n_flip = n_all = 0
    for name, p in ref.items():
        ours = named[name].detach().numpy()
        close = np.isclose(ours, p, rtol=1e-5, atol=2e-7)
        assert np.all(np.abs(ours - p)[~close] <= 2 * lr), name
        n_flip += int((~close).sum())
        n_all += close.size
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)
    adam = _find_adam_state(jstate.opt_state)
    mu = weights.flax_params_to_state_dict({"lgm": jax.tree.map(
        lambda x: np.asarray(x, np.float32), adam.mu["lgm"])})
    nu = weights.flax_params_to_state_dict({"lgm": adam.nu["lgm"]})
    for n, m_, v_ in zip(names, state.optimizer.mu, state.optimizer.nu):
        jm_, jv_ = mu["lgm." + n], nu["lgm." + n]
        np.testing.assert_allclose(m_.float().numpy(), jm_, rtol=0,
                                   atol=2 ** -7 * np.abs(jm_).max() + 1e-7,
                                   err_msg=n)
        np.testing.assert_allclose(v_.numpy(), jv_, rtol=0,
                                   atol=2e-3 * np.abs(jv_).max() + 1e-13,
                                   err_msg=n)


def test_ckpt_to_torch_is_read_by_infer(jax_run):
    """``infer --resume`` reads the converted file: the LGM's parameters,
    LPIPS's dropped, strictly."""
    jstate, _, _, path = jax_run
    sd = weights.load_state_dict_file(path)
    model = LGM(get_config("nano"))
    weights.load_state_dict_into(model, sd)
    ref = weights.flax_params_to_state_dict(
        jax.device_get(jstate.params["lgm"]))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("k_steps", [2, 3])
def test_multi_steps_state_maps_to_optimizer(jax_run, k_steps):
    """Under gradient accumulation (optax.MultiSteps) the mini-step and the
    running mean of the gradients carry over, and the port's optimizer
    resumed from them makes lgm_tpu's next update (``jax.jit`` of optax's,
    ROADMAP C4) to 1e-6 relative."""
    jstate = jax_run[0]
    jopt = jax_get_config("nano").replace(
        lambda_lpips=1.0, gradient_accumulation_steps=k_steps)
    opt = get_config("nano").replace(lambda_lpips=1.0,
                                     gradient_accumulation_steps=k_steps)
    params = jax.device_get(jstate.params)
    tx = jtrain.make_optimizer(jopt)
    rng = np.random.default_rng(k_steps)
    grads = [jax.tree.map(lambda x: rng.normal(0, 1e-3, x.shape).astype(
        np.float32), params) for _ in range(k_steps)]
    update = jax.jit(tx.update)
    ostate = tx.init(params)
    for g in grads[:-1]:
        _, ostate = update(g, ostate, params)
    names = _lgm_names(opt)
    ckpt = weights.lgm_train_state_to_torch(
        {"params": params, "opt_state": jax.device_get(ostate), "step": 0},
        names)
    assert ckpt["opt_state"]["mini_step"] == k_steps - 1
    model = LGM(opt)
    weights.load_state_dict_into(model, {
        k[len("lgm."):]: v for k, v in ckpt["params"].items()
        if k.startswith("lgm.")})
    optim = train.Optimizer(list(model.parameters()), opt)
    optim.load_state_dict(ckpt["opt_state"])
    upd, _ = update(grads[-1], ostate, params)
    want = weights.flax_params_to_state_dict(
        {"lgm": optax.apply_updates(params, upd)["lgm"]})
    last = weights.flax_params_to_state_dict({"lgm": grads[-1]["lgm"]})
    optim.update([torch.as_tensor(last["lgm." + n]) for n in names])
    for n, p in zip(names, optim.params):
        np.testing.assert_allclose(p.detach().numpy(), want["lgm." + n],
                                   rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("name", ["tiny-test", "tiny-test-ip"])
def test_pipeline_to_torch_views_match_jax(name, tmp_path):
    """An lgm_tpu pipeline directory (``save_pretrained``: config.json in
    f32, orbax params from ``from_config`` with the U-Net's zero leaves
    filled, a CLIP vocabulary) -> ``pipeline_to_torch`` -> the port's
    ``from_pretrained``: the four views it generates from the same
    latents over 2 DDIM steps are lgm_tpu's (as ``test_pipeline_matches_
    jax`` holds them; the ip config's stem bias is zero there too, for
    the uncond branch's zero frame)."""
    ip = name.endswith("-ip")
    cfg = dataclasses.replace(jpipe.CONFIGS[name], compute_dtype="float32")
    params = jax.device_get(jpipe.MVDreamPipeline.from_config(
        name, seed=3).params)
    params["unet"] = _fill_zeros(params["unet"], np.random.default_rng(4))
    if ip:
        params["unet"]["input_conv"]["bias"] = np.zeros_like(
            params["unet"]["input_conv"]["bias"])
    src = tmp_path / "jax"
    jpipe.MVDreamPipeline(cfg, params=params).save_pretrained(str(src))
    shutil.copytree(FIX, src / "tokenizer")
    _script("pipeline_to_torch").main([str(src), str(tmp_path / "torch")])
    jp = jpipe.MVDreamPipeline.from_pretrained(str(src), name=name)
    tp = tpipe.MVDreamPipeline.from_pretrained(str(tmp_path / "torch"),
                                               device="cpu")
    # Without an image encoder the vision fields are not written.
    skip = {"allow_hash_tokenizer"} | (set() if ip else {
        "vision_hidden", "vision_layers", "vision_heads", "image_size",
        "patch_size"})
    got = dataclasses.asdict(tp.cfg)
    for k, v in dataclasses.asdict(cfg).items():
        assert k in skip or got[k] == v, (k, got[k], v)
    rng = np.random.default_rng(11)
    frames = 5 if ip else 4
    kw = dict(prompt="a red chair", negative_prompt="blurry", height=32,
              width=32, elevation=15.0, num_inference_steps=2,
              guidance_scale=5.0,
              latents=rng.normal(0, 1, (frames, 16, 16, 4)).astype(
                  np.float32))
    if ip:
        kw["image"] = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    ref = np.asarray(jp(output_type="latent", **kw))[:4]
    lat = tp(output_type="latent", **kw)[:4]
    assert np.abs(ref - kw["latents"][:4]).max() > 1e-2
    assert np.abs(lat - ref).max() <= 1e-3 * np.abs(ref).max()
    assert np.abs(tp.decode_latents(lat)
                  - jp.decode_latents(ref)).max() <= 2e-3


def _lpips_torch_files(tmp_path, prefix, heads):
    """A vgg16-structured backbone at reduced widths and its LPIPS heads,
    saved as torch ``.pth`` files under the given names."""
    gen = torch.Generator().manual_seed(5)
    stages = ((2, 8), (2, 16), (3, 32), (3, 32), (3, 32))
    idx = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
    vgg, lin, cin = {}, {}, 3
    for (n, ch), ids in zip(stages, idx):
        for i in ids[:n]:
            vgg[f"{prefix}features.{i}.weight"] = torch.randn(
                ch, cin, 3, 3, generator=gen)
            vgg[f"{prefix}features.{i}.bias"] = torch.randn(ch, generator=gen)
            cin = ch
    for k, (_, ch) in enumerate(stages):
        lin[f"{prefix}{heads}{k}.model.1.weight"] = torch.rand(
            1, ch, 1, 1, generator=gen)
    paths = str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth")
    torch.save(vgg, paths[0])
    torch.save({"state_dict": lin} if prefix else lin, paths[1])
    return paths, stages


@pytest.mark.parametrize("prefix,heads", [("", "lin"), ("net.", "lins.")])
@pytest.mark.parametrize("which", ["both", "vgg", "lpips"])
def test_convert_lpips_matches_lgm_tpu(tmp_path, prefix, heads, which):
    """The port's converter and lgm_tpu's write the same keys and values
    from the same ``.pth`` files (canonical names, or under ``net.`` with
    ``lins.`` heads; each file alone or both); the port's
    ``load_lpips_params`` and lgm_tpu's read the result."""
    (vgg, lin), stages = _lpips_torch_files(tmp_path, prefix, heads)
    args = {"both": (vgg, lin), "vgg": (vgg, ""), "lpips": ("", lin)}[which]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    convert_lpips.main([*args, ours])
    jconvert_lpips.convert(*args, theirs)
    a, b = np.load(ours), np.load(theirs)
    assert a.files == b.files and len(a.files) > 0
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = LPIPS(stages)
    load_lpips_params(model, ours)
    img = jnp.zeros((1, 16, 16, 3))
    jparams = jax_load_lpips(ours, JaxLPIPS(stages=stages).init(
        jax.random.PRNGKey(0), img, img)["params"])
    sd = weights.flax_params_to_state_dict(
        {"lgm": {}, "lpips_loss": {"m": jax.device_get(jparams)}})
    own = model.state_dict()
    for k in a.files:
        name = k.replace("/kernel", ".weight").replace("/", ".")
        np.testing.assert_array_equal(own[name].numpy(),
                                      sd["lpips_loss." + name], err_msg=k)
