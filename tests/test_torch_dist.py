"""Multi-process training of the port on the CPU over gloo: worlds of 2
ranks (dp 2) and 4 ranks (dp 2 x vp 2, ZeRO-1; dp 1 x vp 4 with four
input views, one a rank) launched through torch.distributed.run, each one
step of nano in fp32 on the synthetic global batch, against the
one-process run of lgm_tpu_torch.train on the same options (which
test_torch_train.py holds against lgm_tpu's step); under vp the U-Net is
view-sharded (each rank runs B·V/vp input views, gathering the others'
keys, values and Gaussians); the rank slices of a loader batch; a ZeRO-1
checkpoint loaded in one process.

Tolerances: the ranks' gradients are averaged by DistributedDataParallel
in another order than one process's batch mean, so values agree to f32
rounding. Parameters after the step: 1e-5 relative + 2e-7, except where a
gradient is f32 noise, which Adam's first step (g/|g|) may turn either way
by up to lr (at most 0.1% of the elements, each within 2 lr). Adam's bf16
first moment to two bf16 steps of each leaf's scale + 1e-7, the f32 second
moment to 2e-3 of its scale + 1e-13 (the floor of gradients that are f32
noise). Logged scalars: 1e-5 relative."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lgm_tpu_torch import train
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.data import provider
from lgm_tpu_torch.io import png
from lgm_tpu_torch.parallel import dist
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["nano", "--device", "cpu", "--mixed-precision", "fp32",
        "--total-steps", "1"]

# Runs train.main in a rank of torch.distributed.run and saves, beside
# the checkpoint, what the rank held: its ZeRO-1 axes and Adam moments,
# and the shape of every input its U-Net ran on.
_DRIVER = r"""
import os, sys, torch
from lgm_tpu_torch import train
from lgm_tpu_torch.models import unet
save = train.save_checkpoint
unet_in = []
forward = unet.UNet.forward

def unet_spy(self, x, *args, **kwargs):
    unet_in.append(tuple(x.shape))
    return forward(self, x, *args, **kwargs)

def spy(workspace, state, step, world=None):
    o = state.optimizer
    torch.save({"axes": o.axes, "mu": o.mu, "nu": o.nu, "dp": world.dp,
                "dp_rank": world.dp_rank, "unet_in": unet_in},
               os.path.join(workspace, f"rank{world.rank}.pt"))
    return save(workspace, state, step, world)

unet.UNet.forward = unet_spy
train.save_checkpoint = spy
train.main(sys.argv[1:])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp, name, nproc, extra=()):
    """A run of the trainer (one process, or ``nproc`` ranks) into
    workspace ``name``: (workspace, stdout)."""
    shim = tmp / "no_tensorboard" / "tensorboard"
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "__init__.py").write_text("raise ImportError('hidden')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(shim.parent), ROOT]))
    ws = str(tmp / name)
    args = [*ARGS, "--workspace", ws, *extra]
    if nproc == 1:
        cmd = [sys.executable, "-u", "-m", "lgm_tpu_torch.train", *args]
    else:
        driver = tmp / "driver.py"
        driver.write_text(_DRIVER)
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
               "--master_port", str(_free_port()), str(driver), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ws, proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    return {"one": _run(tmp, "one", 1),
            "dp2": _run(tmp, "dp2", 2),
            "dp2_vp2_zero1": _run(tmp, "dp2_vp2_zero1", 4,
                                  ["--vp", "2", "--zero1", "1"]),
            "dp2_zero1": _run(tmp, "dp2_zero1", 2, ["--zero1", "1"]),
            "one_v4": _run(tmp, "one_v4", 1, V4),
            "dp1_vp4": _run(tmp, "dp1_vp4", 4, [*V4, "--vp", "4"])}


# Four input views (nano has two), so that vp 4 puts one on each rank.
V4 = ["--num-input-views", "4"]
# The one-process run each world is held to (the same options).
REFERENCE = {"dp1_vp4": "one_v4"}


def _ckpt(ws):
    return torch.load(os.path.join(ws, "ckpt_1"), weights_only=True)


def _metrics(ws):
    with open(os.path.join(ws, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _assert_state_close(ours, ref):
    opt = get_config("nano")
    lr = train.current_lr(opt, 0)
    n_flip = n_all = 0
    assert set(ours["params"]) == set(ref["params"])
    for name, p in ref["params"].items():
        q = ours["params"][name]
        close = torch.isclose(q, p, rtol=1e-5, atol=2e-7)
        assert torch.all((q - p).abs()[~close] <= 2 * lr), name
        n_flip += int((~close).sum())
        n_all += close.numel()
    assert n_flip <= 1e-3 * n_all, (n_flip, n_all)
    for m, rm in zip(ours["opt_state"]["mu"], ref["opt_state"]["mu"]):
        assert m.dtype == torch.bfloat16 and m.shape == rm.shape
        torch.testing.assert_close(
            m.float(), rm.float(), rtol=0,
            atol=2 ** -7 * rm.float().abs().max().item() + 1e-7)
    for v, rv in zip(ours["opt_state"]["nu"], ref["opt_state"]["nu"]):
        torch.testing.assert_close(
            v, rv, rtol=0, atol=2e-3 * rv.abs().max().item() + 1e-13)
    assert ours["step"] == ref["step"] == 1


@pytest.mark.parametrize("world", ["dp2", "dp2_vp2_zero1", "dp2_zero1",
                                   "dp1_vp4"])
def test_step_matches_one_process(runs, world):
    """After one step, the world's parameters and optimizer state (the
    checkpoint, gathered from the ZeRO-1 slices where sharded) are the
    one-process step's on the same global batch."""
    ref = REFERENCE.get(world, "one")
    _assert_state_close(_ckpt(runs[world][0]), _ckpt(runs[ref][0]))


@pytest.mark.parametrize("world,ranks,dp,views", [
    ("dp2", 2, 2, 2), ("dp2_vp2_zero1", 4, 2, 1), ("dp1_vp4", 4, 1, 1)])
def test_each_rank_runs_its_views_through_the_unet(runs, world, ranks, dp,
                                                   views):
    """Every U-Net call of every rank (the step's and the eval's) ran on
    the rank's B = batch / dp scenes x V/vp input views: under vp the
    U-Net is view-sharded, not replicated."""
    opt = get_config("nano")
    B, s = opt.batch_size // dp, opt.input_size
    for rank in range(ranks):
        held = torch.load(os.path.join(runs[world][0], f"rank{rank}.pt"),
                          weights_only=True)
        assert len(held["unet_in"]) >= 2
        assert set(held["unet_in"]) == {(B * views, 9, s, s)}, \
            (rank, held["unet_in"])


@pytest.mark.parametrize("world", ["dp2", "dp2_vp2_zero1", "dp1_vp4"])
def test_logged_metrics_reduce_to_one_process(runs, world):
    """Rank 0 alone logs (one train and one eval record, one printed step
    line), and the logged loss, psnr (reduced through its mse) and
    gradient norm, and the eval means, are the one-process run's."""
    ws, out = runs[world]
    records = _metrics(ws)
    ref = _metrics(runs[REFERENCE.get(world, "one")][0])
    assert len(records) == len(ref) == 2
    assert sum(l.startswith("step 1:") for l in out.splitlines()) == 1
    assert sum(l.startswith("eval @ 1") for l in out.splitlines()) == 1
    for rec, want in zip(records, ref):
        keys = [k for k in want if "/" in k]
        assert sorted(keys) == sorted(k for k in rec if "/" in k)
        for k in keys:
            np.testing.assert_allclose(rec[k], want[k], rtol=1e-5,
                                       err_msg=f"{world} {k}")


@pytest.mark.parametrize("world,ranks", [("dp2_zero1", 2),
                                         ("dp2_vp2_zero1", 4)])
def test_zero1_shards_and_checkpoint_load_in_one_process(runs, world,
                                                          ranks):
    """A ZeRO-1 checkpoint written by the ranks (dp 2; and dp 2 x vp 2)
    loads in one process and is the state the ranks held: every sharded
    leaf (>= 2^16 elements, on its largest dp-divisible axis) was a 1/dp
    slice on each rank, equal to that slice of the checkpoint's full
    moment (the vp ranks of a dp rank alike); small leaves whole."""
    ws = runs[world][0]
    ckpt = _ckpt(ws)
    opt = get_config("nano").replace(mixed_precision="fp32")
    state = train.load_checkpoint(os.path.join(ws, "ckpt_1"),
                                  train.create_state(opt, "cpu"))
    assert state.step == 1 and state.optimizer.count == 1
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, ckpt["params"][name]), name
    n_sharded = 0
    for rank in range(ranks):
        held = torch.load(os.path.join(ws, f"rank{rank}.pt"),
                          weights_only=True)
        dp_rank = rank // (ranks // 2)
        assert held["dp"] == 2 and held["dp_rank"] == dp_rank
        for i, axis in enumerate(held["axes"]):
            full_mu = state.optimizer.mu[i]
            assert axis == dist.zero1_axis(tuple(full_mu.shape), 2)
            for key in ("mu", "nu"):
                full = getattr(state.optimizer, key)[i]
                assert torch.equal(full, ckpt["opt_state"][key][i])
                want = full if axis is None else full.narrow(
                    axis, dp_rank * full.shape[axis] // 2,
                    full.shape[axis] // 2)
                assert held[key][i].shape == want.shape
                assert torch.equal(held[key][i], want)
            if axis is not None:
                n_sharded += 1
                assert held["mu"][i].numel() * 2 == full_mu.numel()
    assert n_sharded > 0


def test_zero1_axis_rule():
    """lgm_tpu's shard_opt_state rule: >= 2^16 elements, the largest
    dp-divisible axis (the first such), else replicated."""
    assert dist.zero1_axis((96, 96, 3, 3), 2) == 0
    assert dist.zero1_axis((3, 3, 128, 256), 2) == 3
    assert dist.zero1_axis((255, 257), 2) is None
    assert dist.zero1_axis((64, 64), 2) is None
    assert dist.zero1_axis((96, 96, 3, 3), 1) == 0


@pytest.fixture(scope="module")
def lvis_root(tmp_path_factory):
    """Four LVIS-layout scenes of six random 24² RGBA views."""
    root = tmp_path_factory.mktemp("lvis_dist")
    rng = np.random.default_rng(0)
    for s in range(4):
        scene = root / "00000-09999" / f"scene{s:04d}"
        os.makedirs(scene)
        for v in range(6):
            png.write(str(scene / f"{v:03d}.png"),
                      rng.integers(0, 256, (24, 24, 4), dtype=np.uint8))
            np.save(scene / f"{v:03d}.npy", {"elevation": 10.0 * v,
                                             "azimuth": 60.0 * v,
                                             "radius": 1.5})
    return str(root)


def test_rank_slices_of_a_loader_batch(lvis_root):
    """Each dp rank's loader batch is its slice of the global batch (the
    scenes disjoint, their union the global batch in order), and each vp
    rank then keeps its slice of the views and of the input views (vp
    divides them: the U-Net is view-sharded)."""
    opt = get_config("nano").replace(data_path_rendering=lvis_root,
                                     num_input_views=2, num_views=4,
                                     batch_size=0)
    ds = provider.LVISDataset(opt, training=False)
    whole = list(provider.Loader(ds, 4, workers=0).epoch(2))
    parts = [list(provider.Loader(ds, 4, workers=0, rank=r,
                                  ranks=2).epoch(2)) for r in (0, 1)]
    samplers = [provider.BatchSampler(len(ds), 4, rank=r, ranks=2)
                for r in (0, 1)]
    for s in samplers:
        s.set_epoch(2)
    idx = [list(s) for s in samplers]
    assert len(whole) == 1 and set(idx[0][0]).isdisjoint(idx[1][0])
    assert sorted(idx[0][0] + idx[1][0]) == list(range(4))
    for k, v in whole[0].items():
        torch.testing.assert_close(
            torch.cat([parts[0][0][k], parts[1][0][k]]), v, rtol=0, atol=0)
    for rank in range(4):
        world = dist.World(rank=rank, size=4, vp=2)
        ours = dist.shard_views(world, parts[world.dp_rank][0])
        full = parts[world.dp_rank][0]
        assert torch.equal(ours["input"], full["input"][
            :, world.vp_rank:world.vp_rank + 1])
        for k in ("images_output", "masks_output", "cam_view",
                  "cam_view_proj", "cam_pos"):
            assert torch.equal(ours[k], full[k][:, 2 * world.vp_rank:
                                                2 * world.vp_rank + 2])
        assert torch.equal(dist.shard_batch(world, whole[0])["cam_pos"],
                           ours["cam_pos"])
