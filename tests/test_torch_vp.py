"""The view-sharded U-Net's cross-view attention on the CPU over gloo:
one MVAttention site run by worlds of 2 and 4 vp ranks, each rank on its
own V/vp views (the keys and values of the others' gathered), against the
one-process call on all V views: the rank's output rows, the gradient of
its input views, and the parameter gradients summed over the ranks.

Two sites on seeded numpy inputs, B 1, V 4, 8 x 16 tokens a view, 64
channels in 2 heads (BH 2, S 512, D 32):
- bf16, a shape the kernels take at Sq = S/vp, Sk = S (``kernel_takes``),
  so the site goes through ``mha_views`` (K1 and K1ᵇ on the card; here
  their plain versions, f32 dK/dV partials summed over the group);
- fp32, a shape the f32 kernels take, so the site goes through
  ``mha_views`` too (here the plain versions at f32: exact softmax
  attention, f32 dK/dV partials summed over the group).

Tolerances. fp32: the ranks compute the same f32 products, the parameter
gradients summed over ranks in another order: 1e-5 of each tensor's
largest |value|. bf16: the rank's rows and input gradients come from the
same bf16 operands, f32 sums over other matmul blockings may round a bf16
result the other way: 2^-7 of the scale (two bf16 steps, as K1's own
tolerance); a parameter gradient is a bf16 matmul on each rank, rounded
once per rank before the vp sum (as data parallelism rounds each
replica's): vp + 1 bf16 steps of the scale.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lgm_tpu_torch.models.unet import MVAttention
from lgm_tpu_torch.ops.mha import kernel_takes
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, V, H, W, C, HEADS = 1, 4, 8, 16, 64, 2
SITES = {"bf16": torch.bfloat16, "fp32": torch.float32}

# One vp rank: the site on its own views, under gloo; saves its output
# rows, input gradient and parameter gradients, and the route it took.
_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as tdist
from lgm_tpu_torch.models import unet
from lgm_tpu_torch.parallel import dist

rank, n, port, data, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         rank=rank, world_size=n)
group = tdist.new_group(list(range(n)))
routes = []
views, dense = unet.mha_views, unet.dense_attention
unet.mha_views = lambda *a: routes.append("mha_views") or views(*a)
unet.dense_attention = lambda *a: routes.append("dense") or dense(*a)
d = np.load(data)
res = {}
for site, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
    m = unet.MVAttention(int(d["C"]), int(d["heads"]), 0.5, dt)
    m.load_state_dict({k[len("w/"):]: torch.as_tensor(d[k])
                       for k in d.files if k.startswith("w/")})
    B, V = int(d["B"]), int(d["V"])
    part = lambda a: torch.as_tensor(a).reshape(B, V, *a.shape[1:])[
        :, rank * V // n:(rank + 1) * V // n].reshape(-1, *a.shape[1:])
    x = part(d["x"]).to(dt).requires_grad_()
    y = m(x, V // n, group)
    y.float().backward(part(d["g"]))
    res[site + "/y"] = y.detach().float().numpy()
    res[site + "/dx"] = x.grad.float().numpy()
    for name, p in m.named_parameters():
        res[site + "/d/" + name] = p.grad.numpy()
    res[site + "/route"] = np.array(routes.pop())
    assert not routes
np.savez(out, **res)
tdist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vp")
    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    ref = MVAttention(C, HEADS, 0.5, torch.float32)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.as_tensor(rng.normal(0, 0.1, p.shape)))
    d = {"x": rng.normal(0, 1, (B * V, C, H, W)).astype(np.float32),
         "g": rng.normal(0, 1, (B * V, C, H, W)).astype(np.float32),
         "B": B, "V": V, "C": C, "heads": HEADS}
    d.update({"w/" + k: v.numpy() for k, v in ref.state_dict().items()})
    path = tmp / "data.npz"
    np.savez(path, **d)
    return tmp, path, d


def _world(tmp, path, n):
    """Rank results of a gloo world of ``n`` vp ranks."""
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(n), port, str(path),
         str(tmp / f"w{n}_r{r}.npz")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    return [dict(np.load(tmp / f"w{n}_r{r}.npz")) for r in range(n)]


def _one_process(d, dt):
    m = MVAttention(C, HEADS, 0.5, dt)
    m.load_state_dict({k[len("w/"):]: torch.as_tensor(v)
                       for k, v in d.items() if k.startswith("w/")})
    x = torch.as_tensor(d["x"]).to(dt).requires_grad_()
    y = m(x, V)
    y.float().backward(torch.as_tensor(d["g"]))
    return (y.detach().float().numpy(), x.grad.float().numpy(),
            {name: p.grad.numpy() for name, p in m.named_parameters()})


def _close(ours, ref, rel, what):
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("n", [2, 4])
def test_view_sharded_attention_matches_one_process(data, n):
    tmp, path, d = data
    ranks = _world(tmp, path, n)
    S = V * H * W
    for dt in SITES.values():
        assert kernel_takes(dt, S // n, S, C // HEADS, (C // HEADS) ** -0.5)
    for site, dt in SITES.items():
        y, dx, dparams = _one_process(d, dt)
        bf16 = dt is torch.bfloat16
        assert [str(r[site + "/route"]) for r in ranks] == ["mha_views"] * n
        rel = 2.0 ** -7 if bf16 else 1e-5
        views = B * V // n  # B = 1: rank r holds rows r*V/n ..
        for r, res in enumerate(ranks):
            rows = slice(r * views, (r + 1) * views)
            _close(res[site + "/y"], y[rows], rel, (site, n, r, "y"))
            _close(res[site + "/dx"], dx[rows], rel, (site, n, r, "dx"))
        rel_p = (n + 1) * 2.0 ** -8 if bf16 else 1e-5
        for name, ref in dparams.items():
            total = sum(res[site + "/d/" + name] for res in ranks)
            _close(total, ref, rel_p, (site, n, name))
