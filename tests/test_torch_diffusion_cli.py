"""The finetune's command line, ``python -m lgm_tpu_torch.diffusion.train``,
on the CPU in subprocesses (tiny-test, synthetic 32² frames, 2 scenes a
step): two steps with a checkpoint after each and the export, a run
resumed from the first checkpoint, and the same two steps over two
ranks (dp 2, gloo, through torch.distributed.run) against one process;
without ``--device cpu`` it asks for a card.

Tolerances of the two-rank run (DistributedDataParallel averages the
ranks' gradients in another order than one process's batch mean, and
each rank's VAE encodes one scene instead of two): the logged loss to
1e-5 relative; parameters, EMA and Adam's moments as
tests/diffusion_twins.py states them for the twins."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffusion_twins import assert_params_close
from lgm_tpu_torch.diffusion import pipeline as tpipe
from lgm_tpu_torch.diffusion import train as dtrain
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
ARGS = ["--pipeline", "tiny-test", "--device", "cpu", "--image-size", "32",
        "--batch-size", "2", "--total-steps", "2", "--save-every", "1",
        "--warmup-steps", "1", "--lr", str(LR), "--cond-drop", "0.5"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp, name, extra=(), nproc=1):
    """The CLI into workspace ``name`` (one process, or ``nproc`` ranks),
    with one OpenMP thread and TensorBoard hidden (JSONL only, as
    tests/test_torch_train.py::_cli_env)."""
    shim = tmp / "no_tensorboard" / "tensorboard"
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "__init__.py").write_text("raise ImportError('hidden')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(shim.parent), ROOT]))
    ws = tmp / name
    args = [*ARGS, "--workspace", str(ws), *extra]
    if nproc == 1:
        cmd = [sys.executable, "-u", "-m", "lgm_tpu_torch.diffusion.train"]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
               "--master_port", str(_free_port()), "-m",
               "lgm_tpu_torch.diffusion.train"]
    proc = subprocess.run(cmd + args, capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ws, proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcli")
    one = _run(tmp, "one", ["--export", str(tmp / "one" / "export")])
    return {"one": one,
            "resumed": _run(tmp, "resumed",
                            ["--resume", str(one[0] / "dckpt_1")]),
            "dp2": _run(tmp, "dp2", ["--export", str(tmp / "dp2" / "export")],
                        nproc=2)}


def _ckpt(ws, step):
    return torch.load(ws / f"dckpt_{step}", weights_only=True)


def _metrics(ws):
    with open(ws / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


def test_cli_saves_resumes_and_exports(runs):
    ws, out = runs["one"]
    assert sorted(os.listdir(ws)) == ["dckpt_1", "dckpt_2", "export",
                                      "metrics.jsonl"]
    assert "step 1: loss" in out and "exported pipeline" in out
    (rec,) = _metrics(ws)
    assert rec["step"] == 1 and np.isfinite(rec["diffusion/loss"])
    assert np.isfinite(rec["diffusion/gnorm"])
    ckpt = _ckpt(ws, 2)
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2
    # The export holds the EMA U-Net of the last checkpoint.
    pipe = tpipe.MVDreamPipeline.from_pretrained(str(ws / "export"),
                                                 device="cpu")
    for n, v in pipe.unet.state_dict().items():
        assert torch.equal(v, ckpt["ema"][n]), n
    assert any(not torch.equal(ckpt["ema"][n], ckpt["unet"][n])
               for n in ckpt["ema"])
    # Resumed from dckpt_1: one step, to dckpt_2.
    rws, rout = runs["resumed"]
    assert sorted(f for f in os.listdir(rws) if f.startswith("dckpt")) == \
        ["dckpt_2"]
    assert "step 1:" not in rout
    back = _ckpt(rws, 2)
    assert back["step"] == 2 and back["opt_state"]["count"] == 2


def test_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtrain.main(["--pipeline", "tiny-test", "--workspace",
                     str(tmp_path), "--total-steps", "1"])


def test_dp2_over_gloo_matches_one_process(runs):
    """Two ranks on the global batch of two scenes, one each: the
    checkpoints after each step are one process's, rank 0 alone logs and
    exports."""
    (ws, _), (ws2, out2) = runs["one"], runs["dp2"]
    for step in (1, 2):
        ours, ref = _ckpt(ws2, step), _ckpt(ws, step)
        assert ours["step"] == ref["step"] == step
        lr_sum = LR * (step - 1)
        for key in ("unet", "ema"):
            assert_params_close(
                {k: v.numpy() for k, v in ours[key].items()},
                {k: v.numpy() for k, v in ref[key].items()},
                lr_sum, f"{key} {step}")
        for n, rm in ref["opt_state"]["mu"].items():
            torch.testing.assert_close(
                ours["opt_state"]["mu"][n].float(), rm.float(), rtol=0,
                atol=2 ** -7 * rm.float().abs().max().item() + 1e-7)
        for n, rv in ref["opt_state"]["nu"].items():
            torch.testing.assert_close(
                ours["opt_state"]["nu"][n], rv, rtol=0,
                atol=1e-4 * rv.abs().max().item() + 1e-13)
    (rec,), (ref_rec,) = _metrics(ws2), _metrics(ws)
    np.testing.assert_allclose(rec["diffusion/loss"],
                               ref_rec["diffusion/loss"], rtol=1e-5)
    assert out2.count("step 1: loss") == 1
    assert os.path.isdir(ws2 / "export" / "unet")
