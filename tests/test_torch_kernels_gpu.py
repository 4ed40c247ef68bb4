"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor lgm_tpu, so it runs on a host with only PyTorch
and the CUDA toolkit (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from lgm_tpu_torch.ops.gsplat import flatsort as fs
from lgm_tpu_torch.ops.mha import (mha, mha_bwd, mha_bwd_reference, mha_fwd,
                                   mha_reference)
from lgm_tpu_torch.utils import camera

pytestmark = pytest.mark.gpu

FOVY = 49.1
TAN = float(np.tan(0.5 * np.deg2rad(FOVY)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("S,D", [(256, 32), (512, 64), (4096, 32)])
def test_mha_fwd_kernel_matches_plain(cuda, S, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, (3, S, D)),
                               dtype=torch.float32, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = mha_fwd.launches
    with torch.inference_mode():
        o = mha_fwd(q, k, v, D ** -0.5)
        ref = mha_reference(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 1
    # Two bf16 rounding steps of the output scale (different sum orders).
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err


def test_mha_fwd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 64, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(x, x, x, 1.0)  # D = 48
    y = torch.zeros(1, 64, 32, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(y, y, y, 1.0)  # f32
    z = torch.zeros(1, 64, 32, dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    with pytest.raises(NotImplementedError):
        mha_fwd(z, z, z, 1.0)


@pytest.mark.parametrize("tile", [(32, 32), (8, 32)])
def test_composite_fwd_kernel_matches_plain(cuda, tile):
    th, tw = tile
    rng = np.random.default_rng(4)
    n, S = 3000, 128
    g = np.zeros((n, 14), np.float32)
    g[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    g[:, 3] = rng.uniform(0.2, 1.0, n)
    g[:, 4:7] = rng.uniform(0.01, 0.08, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = rng.uniform(0, 1, (n, 3))
    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    for with_depth in (True, False):
        with torch.inference_mode():
            params, counts = fs._prepare_view(
                torch.as_tensor(g, device=cuda),
                torch.as_tensor(view, device=cuda), S, TAN, 1.0, th, tw, 16,
                512, with_depth)
            args = (params, counts, th, tw, S // tw)
            out = fs.composite_fwd(*args)
            ref = fs.composite_reference(*args)
        torch.cuda.synchronize()
        assert int(counts.max()) > 128  # several chunks per tile
        # f32 order + the 1e-4 early-out flipping at its threshold.
        assert (out - ref).abs().max().item() <= 1e-3


def _bf16(rng, shape, dev):
    return torch.as_tensor(rng.normal(0, 1, shape), dtype=torch.float32,
                           device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("BH,S,D", [(2, 256, 32), (2, 256, 64),
                                    (4, 1024, 64), (2, 4096, 32)])
def test_mha_bwd_kernel_matches_plain(cuda, BH, S, D):
    """K1ᵇ vs its plain version from the same residuals: bf16 gradients,
    f32 sums in other orders and bf16 dS / P that may round the other way,
    so two rounding steps of each gradient's scale."""
    rng = np.random.default_rng(S + D)
    q, k, v, do = (_bf16(rng, (BH, S, D), cuda) for _ in range(4))
    scale = D ** -0.5
    o = mha_reference(q, k, v, scale)
    before = mha_bwd.launches
    ours = mha_bwd(q, k, v, o, do, scale)
    ref = mha_bwd_reference(q, k, v, o, do, scale)
    torch.cuda.synchronize()
    assert mha_bwd.launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2.0 ** -7 * b.float().abs().max().item(), (name, err)


def test_mha_autograd_launches_both_kernels(cuda):
    rng = np.random.default_rng(3)
    q, k, v = (_bf16(rng, (2, 512, 32), cuda).requires_grad_()
               for _ in range(3))
    g = _bf16(rng, (2, 512, 32), cuda)
    f0, b0 = mha_fwd.launches, mha_bwd.launches
    (mha(q, k, v, 32 ** -0.5).float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (mha_fwd.launches, mha_bwd.launches) == (f0 + 1, b0 + 1)
    with torch.no_grad():
        o = mha_reference(q, k, v, 32 ** -0.5)
        ref = mha_bwd_reference(q, k, v, o, g, 32 ** -0.5)
    for a, b in zip((q.grad, k.grad, v.grad), ref):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2.0 ** -7 * b.float().abs().max().item()


def test_mha_bwd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 64, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(x, x, x, x, x, 1.0)  # D = 48
    y = torch.zeros(1, 64, 32, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(y, y, y, y, y, 1.0)  # f32
    z = torch.zeros(1, 100, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(z, z, z, z, z, 1.0)  # S % 64


def _scene(n, rng, opaque=0):
    g = np.zeros((n, 14), np.float32)
    g[:, 0:3] = rng.normal(0, 0.3, (n, 3))
    g[:, 3] = rng.uniform(0.2, 1.0, n)
    g[:, 4:7] = rng.uniform(0.01, 0.08, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    g[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    g[:, 11:14] = rng.uniform(0, 1, (n, 3))
    g[:opaque, 3] = 1.0     # large opaque splats: the clamp and early-out
    g[:opaque, 4:7] = 0.25
    return g


def _assert_rows_close(ours, ref, rel=1e-4):
    for r in range(ref.shape[-1]):
        scale = ref[..., r].abs().max().item()
        err = (ours[..., r] - ref[..., r]).abs().max().item()
        assert err <= rel * scale + 1e-6, (r, err, scale)


@pytest.mark.parametrize("tile,opaque", [((32, 32), 0), ((8, 32), 0),
                                         ((32, 32), 600)])
def test_composite_bwd_kernel_matches_plain(cuda, tile, opaque):
    """K2ᵇ vs its plain version on the same slots, forward output and a
    seeded cotangent, with and without depth, over several 128-slot
    chunks; with ``opaque``, tiles stop early at T <= 1e-4. f32 sums over
    the tile's pixels in other orders: 1e-4 of each row's scale."""
    th, tw = tile
    rng = np.random.default_rng(5)
    g = _scene(3000, rng, opaque)
    S = 128
    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    for with_depth in (True, False):
        with torch.no_grad():
            params, counts = fs._prepare_view(
                torch.as_tensor(g, device=cuda),
                torch.as_tensor(view, device=cuda), S, TAN, 1.0, th, tw, 16,
                512, with_depth)
            args = (th, tw, S // tw)
            fo = fs.composite_fwd(params, counts, *args)
            go = torch.as_tensor(rng.normal(0, 1, fo.shape),
                                 dtype=torch.float32, device=cuda)
            before = fs.composite_bwd.launches
            ours = fs.composite_bwd(params, counts, fo, go, *args)
            ref = fs.composite_bwd_reference(params, counts, fo, go, *args)
        torch.cuda.synchronize()
        assert fs.composite_bwd.launches == before + 1
        assert int(counts.max()) > 128
        if opaque:
            work = fs.composite_work(params, counts, *args)
            assert work["slots"] < int(counts.sum())
        _assert_rows_close(ours, ref)


def test_render_grad_launches_both_kernels(cuda):
    """Autograd through render_views on the card runs K2 and K2ᵇ once per
    view and gives the plain path's gradient."""
    from lgm_tpu_torch.ops.gsplat.api import render_views

    rng = np.random.default_rng(6)
    g = torch.as_tensor(_scene(2000, rng)[None], device=cuda)
    views = torch.as_tensor(np.stack([camera.build_camera_inputs(
        camera.orbit_camera(10, az, 1.5)[None], FOVY, 0.5, 2.5)["cam_view"][0]
        for az in (30, 150)])[None], device=cuda)
    tgt = torch.rand(1, 2, 128, 128, 3, device=cuda)

    f0, b0 = fs.composite_fwd.launches, fs.composite_bwd.launches
    gt = g.clone().requires_grad_()
    out = render_views(gt, views, 128, TAN, with_depth=False, dup=32)
    ((out["image"] - tgt) ** 2).mean().backward()
    ours = gt.grad
    torch.cuda.synchronize()
    assert fs.composite_fwd.launches == f0 + 2
    assert fs.composite_bwd.launches == b0 + 2
    gp = g.cpu().requires_grad_()
    out = render_views(gp, views.cpu(), 128, TAN, with_depth=False, dup=32)
    ((out["image"] - tgt.cpu()) ** 2).mean().backward()
    err = (ours.cpu() - gp.grad).abs().max().item()
    assert err <= 1e-3 * gp.grad.abs().max().item(), err


def test_composite_bwd_kernel_refuses_what_it_does_not_take(cuda):
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    params = torch.zeros(4, 128, 9, device=cuda)
    fo = torch.zeros(4, 8, 1024, device=cuda)
    with pytest.raises(ValueError):
        fs.composite_bwd(params[..., :8].contiguous(), counts, fo, fo,
                         32, 32, 2)  # R = 8
    with pytest.raises(ValueError):
        fs.composite_bwd(params, counts.long(), fo, fo, 32, 32, 2)
    with pytest.raises(ValueError):
        small = torch.zeros(4, 8, 25, device=cuda)
        fs.composite_bwd(params, counts, small, small, 5, 5, 2)  # P % 32
