"""LPIPS in the loss, folded: each chunk's gradient to the prediction is
formed in the forward (``models/lpips.py::value_and_grad``) and the
backward only scales it. Held here, on the CPU at nano, to the loop it
replaced, kept below as the plain reference: chunks of 4, 2 or 1 pairs
under ``torch.utils.checkpoint``, recomputed and differentiated in the
backward. The captured graph's bookkeeping (``GraphedFold`` by chunk
shape, dropped when LPIPS's tensors are replaced) runs here on a
stand-in whose "graph" reruns the fold eagerly; the graph itself is held
to the eager fold on the card (``tests/test_torch_kernels_gpu.py``)."""

import types

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from lgm_tpu_torch import train
from lgm_tpu_torch.config import get_config
from lgm_tpu_torch.data.synthetic import make_batch
from lgm_tpu_torch.models import lgm
from lgm_tpu_torch.models.lgm import _resize_nchw_256, _to_nchw
from lgm_tpu_torch.models.lpips import GraphedFold, grad_seed, value_and_grad
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def reference_lpips(model, pred_images, gt_images):
    """The mean LPIPS as ``LGMWithLoss._lpips`` computed it before the
    fold: each chunk checkpointed, its forward recomputed in the backward
    and differentiated there."""
    pr = _resize_nchw_256(_to_nchw(pred_images) * 2 - 1).to(model.dtype)
    gt = _resize_nchw_256(_to_nchw(gt_images) * 2 - 1).to(model.dtype)
    n = pr.shape[0]
    chunk = next(c for c in (4, 2, 1) if n % c == 0)

    def one(a, b):
        return model.lpips_loss(a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1))

    vals = []
    for i in range(0, n, chunk):
        args = (gt[i:i + chunk], pr[i:i + chunk])
        if torch.is_grad_enabled():
            vals.append(checkpoint(one, *args, use_reentrant=False))
        else:
            vals.append(one(*args))
    return torch.cat(vals).mean()


class EagerGraph(GraphedFold):
    """``GraphedFold`` whose "graph" reruns the fold on its static
    buffers: its copies, seed and counters without a CUDA device. Its
    "pool" is itself, or the one it was given."""

    def _capture(self, pool):
        self.given = pool
        return types.SimpleNamespace(replay=self._run,
                                     pool=lambda: pool or self)


@pytest.fixture(scope="module")
def nano():
    """A nano state in bf16 with LPIPS on (its seeded weights), a batch of
    2 scenes x 4 views, and a background."""
    opt = get_config("nano").replace(lambda_lpips=1.0)
    state = train.create_state(opt, "cpu")
    batch = make_batch(np.random.default_rng(0), opt, n_gaussians=64,
                       device="cpu")
    data = {k: v for k, v in batch.items() if k != "scenes"}
    bg = torch.rand(3, generator=torch.Generator().manual_seed(1))
    return opt, state.model, data, bg


def _images(B, V, S=32, seed=0):
    """Prediction (a leaf that needs a gradient) and ground truth
    [B, V, S, S, 3] in [0, 1]."""
    gen = torch.Generator().manual_seed(seed)
    pred = torch.rand(B, V, S, S, 3, generator=gen).requires_grad_()
    return pred, torch.rand(B, V, S, S, 3, generator=gen)


def _loss_and_grad(lpips_fn, model, pred, gt, lam):
    value = lpips_fn(model, pred, gt)
    (lam * value).backward()
    grad, pred.grad = pred.grad, None
    return value.detach(), grad


# (B, V): 8 pairs in chunks of 4, 6 in chunks of 2, 5 in chunks of 1.
CHUNKS = [(2, 4), (2, 3), (1, 5)]


@pytest.mark.parametrize("B,V", CHUNKS)
def test_fold_is_the_checkpointed_loop_bit_for_bit(nano, B, V):
    model = nano[1]
    pred, gt = _images(B, V)
    ours = _loss_and_grad(type(model)._lpips, model, pred, gt, 1.0)
    ref = _loss_and_grad(reference_lpips, model, pred, gt, 1.0)
    assert torch.equal(ours[0], ref[0])
    assert torch.equal(ours[1], ref[1])
    assert ours[1].abs().max() > 0


@pytest.mark.parametrize("B,V", CHUNKS)
def test_fold_scaled_by_half_agrees_within_bf16(nano, B, V):
    """A weight other than 1 scales the stored bf16 gradient, where the
    loop seeded the VJP with it: the same within one bf16 rounding."""
    model = nano[1]
    pred, gt = _images(B, V, seed=1)
    ours = _loss_and_grad(type(model)._lpips, model, pred, gt, 0.5)
    ref = _loss_and_grad(reference_lpips, model, pred, gt, 0.5)
    assert torch.equal(ours[0], ref[0])
    err = (ours[1] - ref[1]).abs().max()
    assert err <= 2.0 ** -8 * ref[1].abs().max(), err


@pytest.mark.parametrize("B,V", CHUNKS)
def test_fold_value_without_grad_is_unchanged(nano, B, V):
    model = nano[1]
    pred, gt = _images(B, V, seed=2)
    with torch.no_grad():
        plain = model._lpips(pred, gt)
        ref = reference_lpips(model, pred, gt)
    assert torch.equal(plain, ref)
    assert torch.equal(plain, model._lpips(pred, gt).detach())


def test_train_step_loss_and_gradients_bit_for_bit(nano, monkeypatch):
    """The whole nano loss: ``loss_lpips``, the rendered prediction's
    gradient and every LGM gradient as the checkpointed loop gives them;
    LPIPS's parameters get none."""
    opt, model, data, bg = nano

    def run():
        out = model(data, bg)
        out["images_pred"].retain_grad()
        out["loss"].backward()
        grads = {k: p.grad for k, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out, grads

    ours, ours_g = run()
    monkeypatch.setattr(lgm.LGMWithLoss, "_lpips", reference_lpips)
    ref, ref_g = run()
    assert torch.equal(ours["loss_lpips"], ref["loss_lpips"])
    assert torch.equal(ours["images_pred"].grad, ref["images_pred"].grad)
    assert ours_g.keys() == ref_g.keys()
    assert all(torch.equal(ours_g[k], ref_g[k]) for k in ref_g)
    assert not any(k.startswith("lpips_loss.") for k in ours_g)
    assert not any(p.requires_grad for p in model.lpips_loss.parameters())


@pytest.mark.parametrize("n", [8, 6])
def test_graph_stand_in_replays_the_eager_fold(nano, n):
    """Static inputs copied in, the seed of a mean over n: a replay's
    outputs are the eager fold's, bit for bit."""
    model = nano[1]
    fn = lambda a, b: lgm._lpips_nchw(model.lpips_loss, a, b)  # noqa: E731
    gen = torch.Generator().manual_seed(3)
    a, b = (torch.rand(3, 2, 3, 32, 32, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    graph = EagerGraph(fn, a[0], b[0], n)
    for i in (1, 2, 0):
        got = graph(a[i], b[i])
        want = value_and_grad(fn, a[i], b[i], grad_seed(2, n, "cpu"))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_graphs_by_chunk_shape_dropped_when_lpips_moves(nano, monkeypatch):
    monkeypatch.setattr(lgm, "GraphedFold", EagerGraph)
    model = nano[1]
    model._lpips_graphs.clear()
    x = torch.zeros(4, 3, 32, 32, dtype=torch.bfloat16)
    first = model._lpips_graph(x, x, 8)
    assert first.given is None
    assert model._lpips_graph(x, x, 8) is first
    second = model._lpips_graph(x[:2], x[:2], 6)
    third = model._lpips_graph(x, x, 12)   # the same shape, another mean
    assert len({first, second, third}) == 3
    assert len(model._lpips_graphs) == 3
    assert second.given is first and third.given is first  # one pool
    conv = model.lpips_loss.vgg.conv0_0
    with torch.no_grad():  # updated in place: the graphs still read it
        conv.weight.copy_(conv.weight)
    assert model._lpips_graph(x, x, 8) is first
    saved = conv.weight.data
    try:
        conv.weight.data = saved.clone()  # replaced: every graph goes
        assert model._lpips_graph(x, x, 8) is not first
        assert len(model._lpips_graphs) == 1
    finally:
        conv.weight.data = saved
        model._lpips_graphs.clear()
