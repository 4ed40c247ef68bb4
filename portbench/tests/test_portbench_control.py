"""The output check fails what it must: the control (the reference in fp8,
the precision below the configuration's bf16) and a run whose timed path
is broken underneath; and passes the program in f32.

Each drives the harness without its look for a card, at a size a CPU test
holds, against the cell's own limits.
"""

import math
import time

import torch

from conftest import SMALL

from portbench import harness

TRAIN, OBJECT = "lgm-big.train-bs8", "lgm-big.object-orbit"


def limits(cell):
    return harness.load_json(harness.HERE / "workloads"
                             / f"{cell}.json")["limits"]


def fails(numbers, cell) -> bool:
    lim = limits(cell)
    return any(not math.isfinite(v) or v > lim[k] for k, v in numbers.items())


def run(cell, seed=2**31 + 77, **over):
    from conftest import nano_options

    opts, traffic = SMALL[cell]
    return harness.run_cell(cell, seed, 0.01, False, time.time(),
                            device="cpu",
                            options=nano_options(**dict(opts, **over)),
                            traffic=traffic, log=lambda s: None)


def cell_set_up(cell, seed=2**31 + 78):
    from conftest import nano_options

    opts, traffic = SMALL[cell]
    ctx = harness.build_context(cell, seed, "cpu", nano_options(**opts),
                                traffic)
    c = harness.traffic_module(ctx.mix).Cell(ctx)
    c.setup()
    return c


def test_train_control_fails_a_whole_run():
    """The control in the program's place, through ``run_cell``'s own
    verdict (``calibrate.py --verdict control`` on the card)."""
    from conftest import nano_options

    from portbench import calibrate

    opts, traffic = SMALL[TRAIN]
    out = calibrate.verdict(TRAIN, 2**31 + 78, "control", 0.01,
                            device="cpu", options=nano_options(**opts),
                            traffic=traffic)
    assert out["correct"] is False, out


def test_object_control_fails_a_whole_run():
    """The control in the program's place, through ``run_cell``'s own
    verdict (``calibrate.py --verdict control`` on the card)."""
    from conftest import nano_options

    from portbench import calibrate

    opts, traffic = SMALL[OBJECT]
    out = calibrate.verdict(OBJECT, 2**31 + 79, "control", 0.01,
                            device="cpu", options=nano_options(**opts),
                            traffic=traffic)
    assert out["correct"] is False, out


def test_object_control_fails():
    from portbench.traffic.object import compare

    c = cell_set_up(OBJECT)
    c.window(0.01)
    assert fails(compare(*c.control(c.sample())), OBJECT)


def test_train_in_f32_is_correct():
    result = run(TRAIN, mixed_precision="fp32")
    assert result["correct"], result["checks"]


def test_object_in_f32_is_correct():
    result = run(OBJECT, mixed_precision="fp32")
    assert result["correct"], result["checks"]


def test_step_that_changes_nothing_is_caught(monkeypatch):
    from lgm_tpu_torch import train

    real = train.train_step

    def unchanged(state, data, bg):
        keep = [p.detach().clone() for p in state.optimizer.params]
        moments = [(m.clone(), n.clone()) for m, n in
                   zip(state.optimizer.mu, state.optimizer.nu)]
        out = real(state, data, bg)
        with torch.no_grad():
            for p, k in zip(state.optimizer.params, keep):
                p.copy_(k)
            for (m, n), (m0, n0) in zip(
                    zip(state.optimizer.mu, state.optimizer.nu), moments):
                m.copy_(m0)
                n.copy_(n0)
        state.optimizer.count -= 1
        return out

    monkeypatch.setattr(train, "train_step", unchanged)
    assert not run(TRAIN, mixed_precision="fp32")["correct"]


def test_half_the_batch_is_caught(monkeypatch):
    from lgm_tpu_torch import train

    real = train.train_step

    def half(state, data, bg):
        n = data["input"].shape[0] // 2
        return real(state, {k: v[:n] for k, v in data.items()}, bg)

    monkeypatch.setattr(train, "train_step", half)
    assert not run(TRAIN, mixed_precision="fp32")["correct"]


def test_altered_answer_is_caught(monkeypatch):
    from lgm_tpu_torch import infer

    real = infer.forward_gaussians

    def altered(model, views):
        g = real(model, views)
        g[..., 11:14] = g[..., 13:10:-1]   # the colours' channels reversed
        return g

    monkeypatch.setattr(infer, "forward_gaussians", altered)
    assert not run(OBJECT, mixed_precision="fp32")["correct"]


def test_no_run_loads_jax_or_the_jax_package():
    """A whole run of each cell, in a process of its own, loads no module
    whose top-level name is jax, jaxlib, flax or lgm_tpu (compared whole:
    the port, lgm_tpu_torch, passes)."""
    import subprocess
    import sys

    from conftest import ROOT

    code = f"""
import sys, time, json
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
import torch
torch.set_num_threads(2)
from conftest import SMALL, nano_options
from portbench import harness
for cell, (opts, traffic) in SMALL.items():
    harness.run_cell(cell, 5, 0.01, False, time.time(), device="cpu",
                     options=nano_options(**opts), traffic=traffic,
                     log=lambda s: None)
print(json.dumps(harness.banned_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
    assert harness.banned_modules(["jax.numpy", "lgm_tpu.ops",
                                   "lgm_tpu_torch.train", "jaxtyping",
                                   "flax"]) == ["flax", "jax.numpy",
                                                "lgm_tpu.ops"]
