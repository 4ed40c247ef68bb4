"""The image cell (``imagedream-lgm-big.image-to-3d``) on the CPU: its files
against the program's configuration, its two new readers on made-up
timelines, ``counts/imagedream.py`` against PyTorch's flop counter, and
whole runs at a nano size: the program in f32 passes the check; the
control, one view altered and ε scaled each fail it; no run loads JAX.

The nano size: the pipeline's widths cut to a few channels with a
four-level VAE (``image_to_views`` asks for 256² images, so the U-Net
sees 32² latents), 64² input images, the nano LGM with four views.
"""

import dataclasses
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, nano_options

from portbench import harness
from portbench.counts import imagedream as counts
from portbench.reference import imagedream as ref
from portbench.timeline import WINDOW, Timeline

CELL = "imagedream-lgm-big.image-to-3d"
NANO_PIPELINE = dict(
    model_channels=32, channel_mult=[1, 2], attention_resolutions=[2],
    num_res_blocks=1, num_head_channels=16, context_dim=32,
    vae_channels=[32, 32, 32, 32], text_hidden=32, text_layers=2,
    text_heads=2, vocab_size=1000, max_tokens=16, vision_hidden=48,
    vision_layers=2, vision_heads=2, image_size=32, patch_size=16, ip_dim=4,
    compute_dtype="float32")
NANO_TRAFFIC = {"images": 2, "scene_gaussians": 256, "image_size": 64,
                "frames": 4, "chunk": 2, "check_images": 1}


def nano_sizes():
    return dict(device="cpu",
                options=nano_options(num_input_views=4,
                                     mixed_precision="fp32"),
                traffic=NANO_TRAFFIC)


@pytest.fixture
def nano_pipeline(monkeypatch):
    """The cell's configuration with the pipeline at the nano size."""
    real = harness.build_context

    def small(*a, **k):
        ctx = real(*a, **k)
        ctx.config = dict(ctx.config, pipeline=dict(ctx.config["pipeline"],
                                                    **NANO_PIPELINE))
        return ctx

    monkeypatch.setattr(harness, "build_context", small)


def reader(family):
    return harness.load_module(harness.HERE / "metrics" / f"{family}.py",
                               f"t_{family}").read


def test_configuration_is_the_programs():
    from lgm_tpu_torch.diffusion.pipeline import CONFIGS
    from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer

    from portbench.traffic import image

    cfg = json.loads((harness.HERE / "configs"
                      / "imagedream-lgm-big.json").read_text())
    big = json.loads((harness.HERE / "configs" / "lgm-big.json").read_text())
    assert image.pipeline_fields(cfg) == dataclasses.asdict(
        CONFIGS["imagedream"]) | {"channel_mult": (1, 2, 4, 4),
                                  "attention_resolutions": (4, 2, 1),
                                  "vae_channels": (128, 256, 512, 512)}
    assert cfg["options"] == big["options"]
    assert cfg["assumed"]["init"] == big["assumed"]["init"]
    assert cfg["reduced"] == ["weights"]
    tok = CLIPTokenizer(str(image.TOKENIZER), 77)
    assert tok("").tolist() == image.prompt_ids(77, "cpu").tolist()


def test_denoise_ms_reads_ms_an_image():
    tl = Timeline(spans=[(0, 10_000_000, WINDOW),
                         (1_000_000, 4_000_000, "diffusion.denoise"),
                         (2_000_000, 3_000_000, "diffusion.step"),
                         (5_000_000, 6_000_000, "diffusion.denoise"),
                         (6_000_000, 9_000_000, "views")],
                  window=(0, 10_000_000))
    assert reader("denoise_ms")(tl, {"units": 2}) == pytest.approx(2.0)
    assert reader("denoise_ms")(Timeline(window=(0, 10)),
                                {"units": 2}) is None


def test_denoise_launches_are_read_a_counted_step(monkeypatch):
    from lgm_tpu_torch import trace

    counted = {"diffusion.steps": 4}
    monkeypatch.setattr(trace, "counters", lambda: dict(counted))
    tl = Timeline(
        spans=[(0, 1000, WINDOW), (100, 300, "diffusion.denoise"),
               (150, 200, "diffusion.step"), (500, 800, "diffusion.denoise"),
               (400, 900, "views")],
        ops=[(110, 120, "cudaLaunchKernel"), (160, 170, "cuLaunchKernelEx"),
             (180, 190, "aten::mm"), (350, 360, "cudaLaunchKernel"),
             (510, 520, "cudaLaunchKernelExC"), (790, 850, "cuLaunchKernel"),
             (850, 860, "cudaLaunchKernel")],
        window=(0, 1000))
    assert reader("denoise_launches")(tl, {"units": 2}) == 1.0
    counted.clear()
    assert reader("denoise_launches")(tl, {"units": 2}) is None
    counted["diffusion.steps"] = 4
    assert reader("denoise_launches")(Timeline(window=(0, 10)),
                                      {"units": 1}) is None


@pytest.mark.parametrize("name,device", [("tiny-pipe-ip", "cpu"),
                                         ("imagedream", "meta")])
def test_image_flops_match_the_flop_counter(name, device):
    """Each stage of ``imagedream_image`` against the flop counter over
    the plain reference: at a tiny size on the CPU, at the published
    widths on the meta device; then the whole image, to 0.1%."""
    from lgm_tpu_torch.config import CONFIGS as LGM
    from lgm_tpu_torch.diffusion.pipeline import CONFIGS

    from portbench.counts.flops import lgm_forward
    from portbench.reference import lgm as ref_lgm

    cfg = dataclasses.asdict(CONFIGS[name])
    w = {c: {k: torch.zeros(s, device=device) for k, s in shapes.items()}
         for c, shapes in ref.param_shapes(cfg).items()}
    size = 256 if device == "meta" else 32
    f = 2 ** (len(cfg["vae_channels"]) - 1)
    side, tok = size // f, (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1

    def flops(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()

    def empty(*shape):
        return torch.zeros(shape, device=device)

    ids = torch.zeros(1, cfg["max_tokens"], dtype=torch.long, device=device)
    text = flops(lambda: ref.text_tower(w["text_encoder"], ids, cfg))
    vision = flops(lambda: ref.vision_tower(
        w["image_encoder"], empty(1, 3, cfg["image_size"],
                                  cfg["image_size"]), cfg))
    enc = flops(lambda: ref.vae_encode(w["vae"], empty(1, 3, size, size),
                                       cfg))
    dec = flops(lambda: ref.vae_decode(w["vae"], empty(5, 4, side, side),
                                       cfg))
    unet = flops(lambda: ref.unet(
        w["unet"], empty(10, 4, side, side), empty(10), empty(
            10, cfg["max_tokens"], cfg["context_dim"]), 5, empty(10, 16),
        cfg, empty(10, tok, cfg["vision_hidden"]), empty(2, 4, side, side)))
    assert (text, vision, enc, dec, unet) == (
        counts.text_encode(cfg), counts.vision_encode(cfg),
        counts.vae_encode(cfg, size), counts.vae_decode(cfg, side, 5),
        counts.unet_call(cfg, 5, side, tok))
    opts = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(LGM["big"]).items()}
    p = {k: torch.zeros(s, device="meta")
         for k, s in ref_lgm.param_shapes(opts).items()}
    lgm = flops(lambda: ref_lgm.gaussians(p, torch.zeros(
        1, 4, 256, 256, 9, device="meta"), opts))
    whole = 2 * text + vision + enc + 30 * unet + dec + lgm
    assert counts.imagedream_image(cfg, opts, 30, 4, size) == pytest.approx(
        whole, rel=1e-3)
    assert lgm == lgm_forward(opts, 1)
    if device == "meta":
        assert whole / 1e12 == pytest.approx(71.04, abs=0.01)


def test_image_in_f32_is_correct(nano_pipeline):
    result = harness.run_cell(CELL, 2**31 + 81, 0.01, False, time.time(),
                              log=lambda s: None, **nano_sizes())
    assert result["correct"], result["checks"]


def test_image_control_fails_a_whole_run(nano_pipeline):
    """The control in the program's place, through ``run_cell``'s own
    verdict (``calibrate.py --verdict control`` on the card)."""
    from portbench import calibrate

    out = calibrate.verdict(CELL, 2**31 + 82, "control", 0.01,
                            **nano_sizes())
    assert out["correct"] is False, out


@pytest.mark.parametrize("fault,check", [("view", "view_gap"),
                                         ("eps", "eps_gap")])
def test_planted_fault_is_caught(nano_pipeline, fault, check):
    """One view's colour channels reversed where ``image_to_views``
    returns, or the U-Net's ε scaled by 1.1: the run is not correct, by
    the check that reads that stage."""
    from portbench import calibrate_image

    out = calibrate_image.verdict(2**31 + 83, fault, 0.01, **nano_sizes())
    assert out["correct"] is False
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


def test_image_run_loads_no_jax():
    """A whole run of the image cell, in a process of its own, loads no
    module of JAX or of the JAX package."""
    import subprocess
    import sys

    code = f"""
import sys, time, json
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
import torch
torch.set_num_threads(2)
import test_portbench_image as t
from portbench import harness
real = harness.build_context
def small(*a, **k):
    ctx = real(*a, **k)
    ctx.config = dict(ctx.config, pipeline=dict(ctx.config["pipeline"],
                                                **t.NANO_PIPELINE))
    return ctx
harness.build_context = small
harness.run_cell(t.CELL, 5, 0.01, False, time.time(), log=lambda s: None,
                 **t.nano_sizes())
print(json.dumps(harness.banned_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
