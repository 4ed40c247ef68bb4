"""The frozen references against the program at nano on the CPU, from the
same weights, and the counts against PyTorch's flop counter."""

import ast
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, nano_options

from portbench import harness
from portbench.counts import attention, flops
from portbench.reference import camera, lpips as ref_lpips, scenes, weights
from portbench.reference import lgm as ref_lgm
from portbench.reference import train as ref_train
from portbench.reference.precision import fp8
from portbench.reference.render import render_view

INIT = harness.load_json(harness.HERE / "configs" / "lgm-big.json")[
    "assumed"]["init"]


def options(name):
    from lgm_tpu_torch.config import CONFIGS

    return CONFIGS[name], {k: list(v) if isinstance(v, tuple) else v
                           for k, v in dataclasses.asdict(
                               CONFIGS[name]).items()}


@pytest.mark.parametrize("preset", ["nano", "big"])
def test_counts_match_the_flop_counter(preset):
    opt, cfg = options(preset)
    shapes = ref_lgm.param_shapes(cfg)
    p = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    x = torch.empty(2, cfg["num_input_views"], cfg["input_size"],
                    cfg["input_size"], 9, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_lgm.gaussians(p, x, cfg)
    assert fc.get_total_flops() == flops.lgm_forward(cfg, 2)
    lp = {k: torch.empty(s, device="meta")
          for k, s in ref_lpips.param_shapes().items()}
    img = torch.empty(1, 3, 256, 256, device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_lpips._taps(lp, img, lambda t: t)
    assert fc.get_total_flops() == flops.vgg_forward(256)
    sites = attention.lgm_sites(cfg, 2)
    att = [e for e in ref_lgm.blocks(cfg) if e[0] == "attn"]
    assert len(sites) == len(att)
    if preset == "big":
        assert sorted(set(sites)) == [(32, 256, 64), (32, 1024, 64),
                                      (32, 4096, 32)]
        assert sum(s == (32, 4096, 32) for s in sites) == 5


def test_weight_names_and_shapes_are_the_programs():
    from lgm_tpu_torch.models.lgm import LGMWithLoss

    opt, cfg = options("big")
    with torch.device("meta"):
        model = LGMWithLoss(opt)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ours = {f"lgm.{k}": s for k, s in ref_lgm.param_shapes(cfg).items()}
    ours.update({f"lpips_loss.{k}": s
                 for k, s in ref_lpips.param_shapes().items()})
    assert own == ours
    assert sum(np.prod(s) for k, s in ours.items()
               if k.startswith("lgm.")) == 415_042_848


def test_lgm_and_lpips_match_the_program():
    from lgm_tpu_torch.models.lgm import LGM
    from lgm_tpu_torch.models.lpips import LPIPS

    opt, cfg = options("nano")
    w = weights.make(ref_lgm.param_shapes(cfg), 2**33 + 5, "cpu", INIT)
    x = torch.randn(2, 2, 32, 32, 9, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = ref_lgm.gaussians(w, x, cfg)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 0.05)):
            m = LGM(opt, dtype=dtype)
            m.load_state_dict(w)
            got = m(x)
            assert ((got - ref).norm() / ref.norm()) < tol
        control = ref_lgm.gaussians(w, x, cfg, fp8)
    assert ((control - ref).norm() / ref.norm()) > 0.05
    lw = weights.make(ref_lpips.param_shapes(), 3, "cpu")
    lp = LPIPS(dtype=torch.float32)
    lp.load_state_dict(lw)
    a, b = (torch.rand(2, 48, 48, 3) * 2 - 1 for _ in range(2))
    torch.testing.assert_close(
        ref_lpips.lpips(lw, a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)),
        lp(a, b), rtol=1e-5, atol=1e-6)


def test_renderer_matches_the_program_with_its_gradient():
    from lgm_tpu_torch.ops.gsplat.api import render_views

    g = torch.as_tensor(scenes.sample_scene(np.random.default_rng(2), 600))
    cv = torch.as_tensor(camera.cam_view(camera.orbit_views(2, 1.5, 15.0)))
    tan = float(np.tan(0.5 * np.deg2rad(49.1)))
    bg = torch.tensor([0.1, 0.6, 0.3])
    for tile_h, tile_w, mpt in ((8, 32, 256), (32, 32, 128)):
        ours_g = g.clone().requires_grad_(True)
        img, alpha = render_view(ours_g, cv[1], 64, tan, bg, 16, tile_h,
                                 tile_w, mpt)
        (img.square().sum() + alpha.sum()).backward()
        prog_g = g.clone().requires_grad_(True)
        out = render_views(prog_g[None], cv[1][None, None], 64, tan,
                           bg_color=bg, dup=16, tile_h=tile_h, tile_w=tile_w,
                           max_per_tile=mpt, with_depth=False)
        (out["image"].square().sum() + out["alpha"].sum()).backward()
        torch.testing.assert_close(img, out["image"][0, 0], atol=2e-6,
                                   rtol=0)
        torch.testing.assert_close(alpha, out["alpha"][0, 0, ..., 0],
                                   atol=2e-6, rtol=0)
        assert ((ours_g.grad - prog_g.grad).norm()
                / prog_g.grad.norm()) < 1e-4


def test_adamw_matches_the_programs_optimizer():
    from lgm_tpu_torch.train import Optimizer

    opt, cfg = options("nano")
    gen = torch.Generator().manual_seed(4)
    p0 = {"a": torch.randn(7, 5, generator=gen),
          "b": torch.randn(3, generator=gen)}
    prog = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    optim = Optimizer(prog, opt)
    ours = {k: v.clone() for k, v in p0.items()}
    adam = ref_train.AdamW(ours, cfg)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) * (step + 1)
                 for k, v in p0.items()}
        optim.update(list(grads.values()))
        adam.step(ours, grads)
    for (k, v), p in zip(ours.items(), prog):
        torch.testing.assert_close(v, p.detach(), rtol=0, atol=1e-7)


def test_training_reference_follows_the_f32_program():
    """The program in f32 and the f32 reference agree on every number the
    check compares far inside the cell's limits."""
    from portbench.traffic.train import compare

    ctx = harness.build_context(
        "lgm-big.train-bs8", 2**32 + 9, "cpu",
        nano_options(mixed_precision="fp32"),
        {"batches": 2, "scene_gaussians": 256, "check_steps": 2})
    cell = harness.traffic_module(ctx.mix).Cell(ctx)
    cell.setup()
    got = compare(cell.readings, cell.reference())
    assert got["gauss_gap"] < 1e-4 and got["grad_med"] < 1e-4
    assert got["step_gap"] < 1e-2


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "lgm_tpu_torch", "lgm_tpu", "jax", "jaxlib", "flax"), (
                    path.name, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.train, portbench.reference.scenes, "
            "portbench.reference.precision, portbench.counts.flops; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"lgm_tpu_torch", "lgm_tpu", "jax", "jaxlib", "flax"}
