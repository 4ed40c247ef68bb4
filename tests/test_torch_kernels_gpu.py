"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor lgm_tpu, so it runs on a host with only PyTorch
and the CUDA toolkit (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

from lgm_tpu_torch.models import lgm as lgm_mod
from lgm_tpu_torch.ops.gsplat import flatsort as fs
from lgm_tpu_torch.ops.gsplat import projection as pj
from lgm_tpu_torch.ops.gsplat import tiled as tt
from lgm_tpu_torch.ops.mha import (mha, mha_bwd, mha_bwd_f32,
                                   mha_bwd_reference, mha_fwd, mha_fwd_f32,
                                   mha_reference, mha_split_tf32,
                                   split_tf32_reference)
from lgm_tpu_torch.utils import camera
from projection_cases import CASES, SIZE, case

pytestmark = pytest.mark.gpu

FOVY = 49.1
TAN = float(np.tan(0.5 * np.deg2rad(FOVY)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# The three (BH, S, D) of K1ᵇ in the LGM-big bs2 step, K1 at B = 1 (BH =
# 16) at S 4096, and two small odd ones that take other block shapes.
MHA_SHAPES = [(16, 4096, 32), (32, 4096, 32), (32, 1024, 64), (32, 256, 64),
              (3, 256, 32), (3, 512, 64)]
# Two bf16 rounding steps of the output scale (sums in other orders; in
# K1ᵇ bf16 dS and P may round the other way).
K1_REL_TOL = 2.0 ** -7
# K1's statistic against the plain version's: both f32, from logits summed
# in other orders and (in the kernel) ex2.approx: 1e-5 of max(1, |L|).
K1_LSE_REL_TOL = 1e-5


def _close(a, b, rel=K1_REL_TOL, floor=0.0):
    """Max abs error within ``rel`` of max(the largest |b|, ``floor``)."""
    err = (a.float() - b.float()).abs().max().item()
    assert err <= rel * max(b.float().abs().max().item(), floor), err


@pytest.mark.parametrize("BH,S,D", MHA_SHAPES)
def test_mha_fwd_kernel_matches_plain(cuda, BH, S, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (_bf16(rng, (BH, S, D), cuda) for _ in range(3))
    before = mha_fwd.launches
    with torch.inference_mode():
        o, lse = mha_fwd(q, k, v, D ** -0.5, return_lse=True)
        ref, ref_lse = mha_reference(q, k, v, D ** -0.5, return_lse=True)
        o_only = mha_fwd(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 2
    assert lse.dtype == torch.float32 and lse.shape == (BH, S)
    _close(o, ref)
    _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
    assert torch.equal(o_only, o)


def _force_block(monkeypatch, D, block):
    """Make every K1 and K1ᵇ launch at head dim ``D`` take ``block``
    consumer warpgroups."""
    import lgm_tpu_torch.ops.mha as mha_mod

    monkeypatch.setattr(mha_mod, "warpgroups",
                        lambda BH, rows, sms, D: block)


def _blocks_built(D):
    """The blocks each kernel is built for at head dim ``D``: 1, 2 and (at
    D 32) 4 consumer warpgroups."""
    return (1, 2, 4) if D == 32 else (1, 2)


def _block_rows(block):
    return 64 * block


@pytest.mark.parametrize("D", [32, 64])
def test_mha_kernels_agree_across_block_shapes(cuda, D, monkeypatch):
    """Every block shape each kernel is built for, against the plain
    versions (the main path's shapes take only some of them)."""
    rng = np.random.default_rng(5)
    q, k, v, do = (_bf16(rng, (2, 256, D), cuda) for _ in range(4))
    scale = D ** -0.5
    with torch.no_grad():
        ref, ref_lse = mha_reference(q, k, v, scale, return_lse=True)
        for block in _blocks_built(D):
            _force_block(monkeypatch, D, block)
            o, lse = mha_fwd(q, k, v, scale, return_lse=True)
            _close(o, ref)
            _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
            for a, b in zip(mha_bwd(q, k, v, o, do, scale, lse),
                            mha_bwd_reference(q, k, v, o, do, scale, lse)):
                _close(a, b)


def test_mha_fwd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 128, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(x, x, x, 1.0)  # D = 48
    y = torch.zeros(1, 128, 32, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(y, y, y, 1.0)  # f16
    f = torch.zeros(1, 128, 32, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(x[..., :32].contiguous(), f, f, 1.0)  # bf16 q, f32 k and v
    with pytest.raises(ValueError):
        mha_fwd(f, f, x[..., :32].contiguous(), 1.0)  # f32 q and k, bf16 v
    w = torch.zeros(1, 192, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(w, w, w, 1.0)  # S % 128
    u = torch.zeros(1, 128, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(u, u, u, -1.0)  # scale <= 0
    z = torch.zeros(1, 128, 32, dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    with pytest.raises(NotImplementedError):
        mha_fwd(z, z, z, 1.0)


@pytest.mark.parametrize("tile", [(32, 32), (8, 32)])
def test_composite_fwd_kernel_matches_plain(cuda, tile):
    """K2 vs its plain version, and the pixel state it writes at each
    128-slot boundary when asked vs the plain version's (the same output
    either way)."""
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
            out_s, state = fs.composite_fwd(*args, return_state=True)
            _, ref_state = fs.composite_reference(*args, return_state=True)
        torch.cuda.synchronize()
        assert int(counts.max()) > 128  # several chunks per tile
        # f32 order + the 1e-4 early-out flipping at its threshold.
        assert (out - ref).abs().max().item() <= 1e-3
        assert torch.equal(out_s, out)
        assert state.shape == (params.shape[0], 4, 6, th * tw)
        assert (state - ref_state).abs().max().item() <= 1e-3
        assert torch.all(state[:, 0, 0] == 1)
        assert torch.all(state[:, 0, 1:] == 0)
        # Past a tile's last composited chunk, a boundary holds its final
        # values.
        done = fs.composite_work(*args)["tile_slots"] <= 3 * 128
        assert torch.equal(state[done, -1, 0], out[done, 4])


def _bf16(rng, shape, dev):
    return torch.as_tensor(rng.normal(0, 1, shape), dtype=torch.float32,
                           device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("BH,S,D", MHA_SHAPES)
def test_mha_bwd_kernel_matches_plain(cuda, BH, S, D):
    """K1ᵇ vs its plain version from the same inputs and K1's statistic:
    bf16 gradients, f32 sums in other orders and bf16 dS / P that may
    round the other way, so two rounding steps of each gradient's scale."""
    rng = np.random.default_rng(S + D)
    q, k, v, do = (_bf16(rng, (BH, S, D), cuda) for _ in range(4))
    scale = D ** -0.5
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, scale, return_lse=True)
    before = mha_bwd.launches
    ours = mha_bwd(q, k, v, o, do, scale, lse)
    ref = mha_bwd_reference(q, k, v, o, do, scale, lse)
    torch.cuda.synchronize()
    assert mha_bwd.launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        _close(a, b)


def test_mha_bwd_kernel_is_deterministic(cuda):
    """No atomics: two runs on the same inputs give the same bits."""
    rng = np.random.default_rng(6)
    q, k, v, do = (_bf16(rng, (32, 1024, 64), cuda) for _ in range(4))
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, 0.125, return_lse=True)
    first = mha_bwd(q, k, v, o, do, 0.125, lse)
    second = mha_bwd(q, k, v, o, do, 0.125, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_mha_autograd_launches_both_kernels(cuda):
    rng = np.random.default_rng(3)
    q, k, v = (_bf16(rng, (2, 512, 32), cuda).requires_grad_()
               for _ in range(3))
    g = _bf16(rng, (2, 512, 32), cuda)
    f0, b0 = mha_fwd.launches, mha_bwd.launches
    out = mha(q, k, v, 32 ** -0.5)
    lse = out.grad_fn.saved_tensors[4]
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (mha_fwd.launches, mha_bwd.launches) == (f0 + 1, b0 + 1)
    with torch.no_grad():
        o, ref_lse = mha_reference(q, k, v, 32 ** -0.5, return_lse=True)
        _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
        ref = mha_bwd_reference(q, k, v, o, g, 32 ** -0.5, ref_lse)
    for a, b in zip((q.grad, k.grad, v.grad), ref):
        _close(a, b)


def test_mha_bwd_kernel_refuses_what_it_does_not_take(cuda):
    lse = torch.zeros(1, 128, device=cuda)
    x = torch.zeros(1, 128, 48, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(x, x, x, x, x, 1.0, lse)  # D = 48
    y = torch.zeros(1, 128, 32, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(y, y, y, y, y, 1.0, lse)  # f16
    f = torch.zeros(1, 128, 32, device=cuda)
    b = torch.zeros(1, 128, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(b, b, b, b, f, 1.0, lse)  # bf16 with an f32 dO
    with pytest.raises(ValueError):
        mha_bwd(f, f, f, b, f, 1.0, lse)  # f32 with a bf16 o
    z = torch.zeros(1, 192, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(z, z, z, z, z, 1.0, torch.zeros(1, 192, device=cuda))  # S % 128
    w = torch.zeros(1, 128, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(w, w, w, w, w, 1.0, lse.double())  # lse not f32
    with pytest.raises(ValueError):
        mha_bwd(w, w, w, w, w, 1.0, lse[:, :64])  # lse not [BH, S]


# Unequal lengths, as on a vp rank of the view-sharded U-Net: (BH, S, D,
# vp), each rank S/vp queries against all S keys. The big preset's three
# site shapes at vp 2 and 4 (at vp 4 the 8² sites are Sq 64, Sk 256, the
# dK/dV kernel's 64-query tiles), and a small odd BH.
MHA_VP_SHAPES = [(16, 4096, 32, 2), (32, 4096, 32, 4), (16, 1024, 64, 4),
                 (32, 1024, 64, 2), (16, 256, 64, 4), (32, 256, 64, 2),
                 (3, 512, 64, 4)]


# The f32 sums of the ranks' dK/dV partials group the queries otherwise
# than the full call's one accumulator: at 4,096 keys they differ by up to
# 6e-6 of the tensor's largest |value| in f32 (measured on the card), so
# where a sum cancels to near 0 its bf16 rounding may differ by more than
# one step of its own magnitude. Allowed: one bf16 step of the element plus
# 2^-16 of the scale.
DKV_SUM_SCALE_TOL = 2.0 ** -16


def _within_one_bf16_step(a, b):
    """Each element of bf16 ``a`` within one bf16 rounding step (at the
    larger of the two magnitudes) of bf16 ``b``, plus DKV_SUM_SCALE_TOL of
    b's largest |value|."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), e - 8)
    slack = DKV_SUM_SCALE_TOL * b.abs().max()
    assert torch.all((a - b).abs() <= step + slack), \
        (a - b).abs().max().item()


@pytest.mark.parametrize("BH,S,D,vp", MHA_VP_SHAPES)
def test_mha_kernels_at_a_vp_ranks_lengths(cuda, BH, S, D, vp):
    """Each rank's K1 (Sq = S/vp, Sk = S) and K1ᵇ with f32 dK/dV partials
    against their plain versions; the ranks' o, lse and dq rows bit for
    bit the full-length call's; the sum of the ranks' f32 dK and dV,
    rounded once to bf16, within one bf16 step of the full call's (and
    the f32 regrouping's allowance, ``DKV_SUM_SCALE_TOL``)."""
    rng = np.random.default_rng(S + D + vp)
    q, k, v, do = (_bf16(rng, (BH, S, D), cuda) for _ in range(4))
    scale = D ** -0.5
    n = S // vp
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, scale, return_lse=True)
        dq, dk, dv = mha_bwd(q, k, v, o, do, scale, lse)
        dk_sum = torch.zeros(BH, S, D, device=cuda)
        dv_sum = torch.zeros(BH, S, D, device=cuda)
        for r in range(vp):
            rows = slice(r * n, (r + 1) * n)
            q_r, do_r = q[:, rows].contiguous(), do[:, rows].contiguous()
            o_r, lse_r = mha_fwd(q_r, k, v, scale, return_lse=True)
            ref, ref_lse = mha_reference(q_r, k, v, scale, return_lse=True)
            _close(o_r, ref)
            _close(lse_r, ref_lse, K1_LSE_REL_TOL, 1.0)
            assert torch.equal(o_r, o[:, rows])
            assert torch.equal(lse_r, lse[:, rows])
            ours = mha_bwd(q_r, k, v, o_r, do_r, scale, lse_r, dkv_f32=True)
            ref = mha_bwd_reference(q_r, k, v, o_r, do_r, scale, lse_r,
                                    dkv_f32=True)
            assert ours[0].dtype == torch.bfloat16
            assert ours[1].dtype == ours[2].dtype == torch.float32
            for a, b in zip(ours, ref):
                assert a.shape == b.shape
                _close(a, b)
            assert torch.equal(ours[0], dq[:, rows])
            dk_sum += ours[1]
            dv_sum += ours[2]
    torch.cuda.synchronize()
    _within_one_bf16_step(dk_sum.to(torch.bfloat16), dk)
    _within_one_bf16_step(dv_sum.to(torch.bfloat16), dv)


def test_mha_bwd_f32_partials_round_to_the_bf16_output(cuda):
    """At equal lengths the f32 dK and dV, rounded to bf16, are the bf16
    call's bit for bit (the same accumulators, rounded once either way),
    and dq is the same."""
    rng = np.random.default_rng(12)
    q, k, v, do = (_bf16(rng, (32, 1024, 64), cuda) for _ in range(4))
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, 0.125, return_lse=True)
        dq, dk, dv = mha_bwd(q, k, v, o, do, 0.125, lse)
        dq32, dk32, dv32 = mha_bwd(q, k, v, o, do, 0.125, lse, dkv_f32=True)
    assert torch.equal(dq32, dq)
    assert torch.equal(dk32.to(torch.bfloat16), dk)
    assert torch.equal(dv32.to(torch.bfloat16), dv)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("Sq", [64, 192])
def test_mha_unequal_lengths_agree_across_block_shapes(cuda, D, Sq,
                                                       monkeypatch):
    """Every block shape each kernel is built for at Sq queries against
    256 keys (Sq 64 and 192: the dK/dV kernel's 64-query tiles), against
    the plain versions, f32 dK/dV partials included."""
    rng = np.random.default_rng(Sq + D)
    q, do = (_bf16(rng, (2, Sq, D), cuda) for _ in range(2))
    k, v = (_bf16(rng, (2, 256, D), cuda) for _ in range(2))
    scale = D ** -0.5
    with torch.no_grad():
        ref, ref_lse = mha_reference(q, k, v, scale, return_lse=True)
        for block in _blocks_built(D):
            if Sq % _block_rows(block):
                continue  # a grid of whole query blocks only
            _force_block(monkeypatch, D, block)
            o, lse = mha_fwd(q, k, v, scale, return_lse=True)
            _close(o, ref)
            _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
            for f32 in (False, True):
                for a, b in zip(
                        mha_bwd(q, k, v, o, do, scale, lse, dkv_f32=f32),
                        mha_bwd_reference(q, k, v, o, do, scale, lse,
                                          dkv_f32=f32)):
                    assert a.dtype == b.dtype
                    _close(a, b)


def test_mha_kernels_refuse_unequal_lengths_they_do_not_take(cuda):
    k = torch.zeros(1, 256, 32, dtype=torch.bfloat16, device=cuda)
    q = torch.zeros(1, 32, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(q, k, k, 1.0)  # Sq % 64
    q = torch.zeros(1, 64, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(q, k[:, :192].contiguous(), k[:, :192].contiguous(), 1.0)
    with pytest.raises(ValueError):
        mha_fwd(q, k, torch.zeros(1, 128, 32, dtype=torch.bfloat16,
                                  device=cuda), 1.0)  # v not k's shape
    lse = torch.zeros(1, 64, device=cuda)
    with pytest.raises(ValueError):
        mha_bwd(q, k, k, k, q, 1.0, lse)  # o not q's shape
    with pytest.raises(ValueError):
        mha_bwd(q, k, k, q, q, 1.0, torch.zeros(1, 256, device=cuda))


def test_mha_views_on_a_one_rank_group_is_mha(cuda):
    """``mha_views`` on a one-rank NCCL group (the gather and the sum are
    then the identity): the forward and the gradients of ``mha``, bit for
    bit (the dK/dV partials go through f32 and round once, as the bf16
    output does), both kernels launched."""
    import socket

    import torch.distributed as tdist

    from lgm_tpu_torch.ops.mha import mha_views

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                             rank=0, world_size=1, device_id=cuda)
    try:
        group = tdist.new_group([0])
        rng = np.random.default_rng(13)
        q, k, v = (_bf16(rng, (16, 1024, 64), cuda) for _ in range(3))
        g = _bf16(rng, (16, 1024, 64), cuda)
        outs = []
        for fn in (lambda a, b, c: mha(a, b, c, 0.125),
                   lambda a, b, c: mha_views(a, b, c, 0.125, group)):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            f0, b0 = mha_fwd.launches, mha_bwd.launches
            out = fn(*xs)
            out.backward(g)
            torch.cuda.synchronize()
            assert (mha_fwd.launches, mha_bwd.launches) == (f0 + 1, b0 + 1)
            outs.append([out.detach()] + [x.grad for x in xs])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        tdist.destroy_process_group()


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


def _heavy_scene(rng, opaque=0):
    """``_scene(3000)`` plus 3,000 faint small splats packed at the centre,
    which fill one 32 x 32 tile of a 128² view to its 1,024 slots beside
    light ones."""
    g = _scene(3000, rng, opaque)
    faint = _scene(3000, rng)
    faint[:, 0:3] = rng.normal(0, 0.03, (3000, 3))
    faint[:, 3] = rng.uniform(0.005, 0.02, 3000)
    faint[:, 4:7] = rng.uniform(0.01, 0.03, (3000, 3))
    return np.concatenate([g, faint])


def _k2b_inputs(cuda, rng, tile, opaque, heavy, with_depth, mpt=512):
    th, tw = tile
    S = 128
    g = _heavy_scene(rng, opaque) if heavy else _scene(3000, rng, opaque)
    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    with torch.no_grad():
        params, counts = fs._prepare_view(
            torch.as_tensor(g, device=cuda),
            torch.as_tensor(view, device=cuda), S, TAN, 1.0, th, tw, 16, mpt,
            with_depth)
        args = (th, tw, S // tw)
        fo, state = fs.composite_fwd(params, counts, *args, return_state=True)
    go = torch.as_tensor(rng.normal(0, 1, fo.shape), dtype=torch.float32,
                         device=cuda)
    return params, counts, fo, go, state, args


@pytest.mark.parametrize("tile,opaque,heavy", [
    ((32, 32), 0, False), ((8, 32), 0, False), ((32, 32), 600, False),
    ((32, 32), 0, True), ((32, 32), 600, True), ((16, 16), 600, True)])
def test_composite_bwd_kernel_matches_plain(cuda, tile, opaque, heavy):
    """K2ᵇ fed K2's state vs its plain replay on the same slots, forward
    output and a seeded cotangent, with and without depth, over several
    128-slot chunks; with ``opaque``, tiles stop early at T <= 1e-4; with
    ``heavy``, one tile is full (1,024 slots) beside light ones. f32 sums
    over the tile's pixels in other orders: 1e-4 of each row's scale."""
    rng = np.random.default_rng(5)
    mpt = 1024 if heavy else 512
    for with_depth in (True, False):
        params, counts, fo, go, state, args = _k2b_inputs(
            cuda, rng, tile, opaque, heavy, with_depth, mpt)
        with torch.no_grad():
            before = fs.composite_bwd.launches
            ours = fs.composite_bwd(params, counts, fo, go, *args,
                                    state=state)
            ref = fs.composite_bwd_reference(params, counts, fo, go, *args)
            work = fs.composite_work(params, counts, *args)
        torch.cuda.synchronize()
        assert fs.composite_bwd.launches == before + 1
        assert int(counts.max()) == mpt if heavy else int(counts.max()) > 128
        if opaque:
            assert work["slots"] < int(counts.sum())
        _assert_rows_close(ours, ref)
        # Dead slots and chunks past the early-out get zero rows.
        walked = (torch.arange(mpt, device=cuda)[None, :]
                  < work["tile_slots"][:, None])
        assert torch.all(ours[~walked] == 0)


def test_composite_bwd_kernel_is_deterministic(cuda):
    """No atomics: two K2ᵇ runs on the same inputs give the same bits."""
    params, counts, fo, go, state, args = _k2b_inputs(
        cuda, np.random.default_rng(9), (32, 32), 600, True, False, 1024)
    first = fs.composite_bwd(params, counts, fo, go, *args, state=state)
    second = fs.composite_bwd(params, counts, fo, go, *args, state=state)
    assert torch.equal(first, second)


def test_composite_bwd_kernel_requires_the_state(cuda):
    """On the card K2ᵇ starts from K2's state: without it, or with a state
    of the wrong shape, it raises (no fallback to a replay)."""
    params, counts, fo, go, state, args = _k2b_inputs(
        cuda, np.random.default_rng(2), (32, 32), 0, False, False)
    with pytest.raises(ValueError):
        fs.composite_bwd(params, counts, fo, go, *args)
    with pytest.raises(ValueError):
        fs.composite_bwd(params, counts, fo, go, *args,
                         state=state[:, :2].contiguous())


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


def _rows_first_close(ours, ref, rel=1e-4):
    """Per row of a [T, 16, K] gradient: 1e-4 of the row's scale."""
    _assert_rows_close(ours.transpose(1, 2), ref.transpose(1, 2), rel)


@pytest.mark.parametrize("tile,opaque,heavy", [
    ((16, 16), 0, False), ((8, 32), 0, False), ((32, 32), 0, False),
    ((32, 32), 600, False), ((16, 16), 600, False), ((32, 32), 0, True),
    ((32, 32), 600, True)])
def test_tile_composite_kernels_match_plain(cuda, tile, opaque, heavy):
    """K3 (and the state it writes when asked) and K3ᵇ fed that state vs
    their plain versions (K3ᵇ's replay) on the same params_tiles, counts
    and pf, over several 128-slot chunks, with every seventh tile's count
    set to 0 (an empty tile whose rows stay); with ``opaque``, tiles stop
    early at T <= 1e-4. Kernel and plain version take power, alpha test
    and clamp from the same f32 roundings: what is left is the order of
    the f32 sums and an early-out flipping at its threshold. Forward 1e-3
    absolute (as K2), backward 1e-4 of each row's scale (as K2ᵇ). With
    ``heavy``, one tile's list is full (K = 1,024) beside light ones."""
    th, tw = tile
    rng = np.random.default_rng(5)
    g = _heavy_scene(rng, opaque) if heavy else _scene(3000, rng, opaque)
    S, K = 128, (1024 if heavy else 512)
    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    with torch.no_grad():
        params, counts, pf = tt._prepare_view(
            torch.as_tensor(g, device=cuda),
            torch.as_tensor(view, device=cuda), S, TAN, 1.0, th, tw, K)
        counts[::7] = 0
        f0, b0 = tt.tile_composite_fwd.launches, tt.tile_composite_bwd.launches
        fo, state = tt.tile_composite_fwd(params, counts, pf,
                                          return_state=True)
        ref, ref_state = tt.tile_composite_reference(params, counts, pf,
                                                     return_state=True)
        go = torch.as_tensor(rng.normal(0, 1, fo.shape), dtype=torch.float32,
                             device=cuda)
        ours = tt.tile_composite_bwd(params, counts, pf, fo, go, state)
        dref = tt.tile_composite_bwd_reference(params, counts, pf, fo, go)
        work = tt._composite_plain(params, counts, pf)[1]
    torch.cuda.synchronize()
    assert (tt.tile_composite_fwd.launches,
            tt.tile_composite_bwd.launches) == (f0 + 1, b0 + 1)
    # K3's chunk-boundary state against the plain version's (as the
    # output: the early-out flipping at its threshold).
    assert state.shape == (params.shape[0], K // 128, 5, pf.shape[0])
    assert (state - ref_state).abs().max().item() <= 1e-3
    assert int(counts.max()) == K if heavy else int(counts.max()) > 128
    if opaque:  # some tile stopped before the end of its list
        assert bool((work * 128 < counts).any())
    assert (fo - ref).abs().max().item() <= 1e-3
    assert torch.all(fo[..., 5:] == 0) and torch.all(fo[::7, :, 4] == 1)
    _rows_first_close(ours, dref)
    skipped = (torch.arange(K, device=cuda)[None, :] // 128
               >= work[:, None])                              # [T, K]
    assert torch.all(ours.transpose(1, 2)[skipped] == 0)
    # Slots past a tile's count keep the zeros they were handed.
    past = torch.arange(K, device=cuda)[None, :] >= counts[:, None]
    assert torch.all(ours.transpose(1, 2)[past] == 0)
    assert torch.all(ours[:, [7, 11, 12, 13, 14, 15]] == 0)


def _k3b_inputs(cuda, rng):
    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    with torch.no_grad():
        params, counts, pf = tt._prepare_view(
            torch.as_tensor(_heavy_scene(rng, 600), device=cuda),
            torch.as_tensor(view, device=cuda), 128, TAN, 1.0, 32, 32, 1024)
        fo, state = tt.tile_composite_fwd(params, counts, pf,
                                          return_state=True)
    go = torch.as_tensor(rng.normal(0, 1, fo.shape), dtype=torch.float32,
                         device=cuda)
    return params, counts, pf, fo, go, state


def test_tile_composite_bwd_kernel_is_deterministic(cuda):
    """No atomics: two K3ᵇ runs on the same inputs give the same bits."""
    params, counts, pf, fo, go, state = _k3b_inputs(
        cuda, np.random.default_rng(9))
    with torch.no_grad():
        first = tt.tile_composite_bwd(params, counts, pf, fo, go, state)
        second = tt.tile_composite_bwd(params, counts, pf, fo, go, state)
    assert torch.equal(first, second)


def test_tile_composite_bwd_kernel_requires_the_state(cuda):
    """On the card K3ᵇ starts from K3's state: without it, or with a state
    of the wrong shape, it raises (no fallback to a replay)."""
    params, counts, pf, fo, go, state = _k3b_inputs(
        cuda, np.random.default_rng(2))
    with pytest.raises(ValueError):
        tt.tile_composite_bwd(params, counts, pf, fo, go)
    with pytest.raises(ValueError):
        tt.tile_composite_bwd(params, counts, pf, fo, go,
                              state[:, :, :4].contiguous())


def test_render_tiled_grad_launches_both_kernels(cuda):
    """Autograd through render_views(backend="pallas_v1") on the card runs
    K3 and K3ᵇ once per view and gives the CPU plain path's image and
    gradient: 1e-3 of the largest gradient, as the flatsort path's test
    (projection and exp round differently on the two devices, and the
    expanded quadratic amplifies that)."""
    from lgm_tpu_torch.ops.gsplat.api import render_views

    rng = np.random.default_rng(6)
    g = torch.as_tensor(_scene(2000, rng)[None], device=cuda)
    views = torch.as_tensor(np.stack([camera.build_camera_inputs(
        camera.orbit_camera(10, az, 1.5)[None], FOVY, 0.5, 2.5)["cam_view"][0]
        for az in (30, 150)])[None], device=cuda)
    tgt = torch.rand(1, 2, 128, 128, 3, device=cuda)

    def grad(g, views, tgt):
        gt = g.clone().requires_grad_()
        out = render_views(gt, views, 128, TAN, backend="pallas_v1")
        ((out["image"] - tgt) ** 2).mean().backward()
        return out["image"].detach(), gt.grad

    f0, b0 = tt.tile_composite_fwd.launches, tt.tile_composite_bwd.launches
    img, ours = grad(g, views, tgt)
    torch.cuda.synchronize()
    assert tt.tile_composite_fwd.launches == f0 + 2
    assert tt.tile_composite_bwd.launches == b0 + 2
    img_cpu, ref = grad(g.cpu(), views.cpu(), tgt.cpu())
    assert (img.cpu() - img_cpu).abs().mean().item() <= 1e-4
    err = (ours.cpu() - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item(), err


def test_tile_composite_kernels_refuse_what_they_do_not_take(cuda):
    params = torch.zeros(4, 16, 128, device=cuda)
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    pf = tt._pixel_features(8, 8, cuda)
    fo = torch.zeros(4, 64, 8, device=cuda)
    with pytest.raises(ValueError):
        tt.tile_composite_fwd(params[:, :, :100].contiguous(), counts, pf)
    with pytest.raises(ValueError):
        tt.tile_composite_fwd(params, counts.long(), pf)
    with pytest.raises(ValueError):  # 25 pixels: not whole warps
        tt.tile_composite_fwd(params, counts, tt._pixel_features(5, 5, cuda))
    with pytest.raises(ValueError):  # 2048 pixels: more than one block
        tt.tile_composite_fwd(params, counts,
                              tt._pixel_features(32, 64, cuda))
    with pytest.raises(ValueError):
        tt.tile_composite_bwd(params, counts, pf, fo, fo[:, :32].contiguous())
    with pytest.raises(NotImplementedError):
        tt.tile_composite_fwd(params.clone().requires_grad_(), counts, pf)
    assert torch.all(tt.tile_composite_fwd(params, counts, pf)[..., 4] == 1)


# ---------------------------------------------------------------------------
# K2 and K3 over thread-block clusters: every built (cluster size, pixels a
# thread) against the plain version, against the others and against itself.
# Each pixel's arithmetic is pinned (one rounding an operation) and the
# early-out vote is tile-wide, so every variant must give the same bits.
# ---------------------------------------------------------------------------


def _bench_view(cuda):
    """chip_smoke.py's bench scene: 65,536 splats from sample_scene(seed 0)
    and view 0 of the 180-frame orbit, 512²."""
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.infer import orbit_video_cameras

    g = torch.as_tensor(sample_scene(np.random.default_rng(0), 65536),
                        device=cuda)
    view = torch.as_tensor(
        orbit_video_cameras(CONFIGS["big"], 180)["cam_view"][0], device=cuda)
    return g, view, 512


def _scene_view(cuda, scene):
    """(gaussians, view, image size) of a named test scene: ``bench``, or
    ``heavy`` (one 32 x 32 tile full beside light ones) and ``early_out``
    (the same with large opaque splats: tiles stop at T <= 1e-4 before
    their count) at 128²."""
    if scene == "bench":
        return _bench_view(cuda)
    rng = np.random.default_rng(5)
    g = _heavy_scene(rng, 600 if scene == "early_out" else 0)
    view = camera.build_camera_inputs(camera.orbit_camera(10, 30, 1.5)[None],
                                      FOVY, 0.5, 2.5)["cam_view"][0]
    return (torch.as_tensor(g, device=cuda), torch.as_tensor(view, device=cuda),
            128)


def _banded_slots(dev, R, tile=(32, 32)):
    """K2's slots [4, 1024, R] for a 2 x 2 grid of tiles whose pixels
    saturate at different chunks. In tile 0, chunk k (k < 4) holds 128
    opaque splats over the k-th quarter of the tile's rows, which takes
    their transmittance below 1e-4, and chunks 4-7 hold faint splats over
    the whole tile; so the tile stops at boundary 4 (512 slots), while a
    block owning only the first quarter would have stopped at boundary 1.
    Tile 1 takes the bands in reverse order, tile 2 stops at its count
    (300), and tile 3 holds only faint splats (all 1,024 slots). Returns
    (params, counts, tiles_x)."""
    th, tw = tile
    rng = np.random.default_rng(11)
    T, mpt, tiles_x = 4, 1024, 2
    slots = np.zeros((T, mpt, 10), np.float32)
    i = np.arange(128)
    for t in range(T):
        tox, toy = (t % tiles_x) * tw, (t // tiles_x) * th
        for c in range(8):
            s = slots[t, c * 128:(c + 1) * 128]
            if c < 4 and t != 3:
                band = 3 - c if t == 1 else c
                x = (i % 16) * tw / 16
                y = band * th / 4 + (i // 16) * th / 32
                sigma, op = 3.0, 0.99
            else:
                x = rng.uniform(0, tw, 128)
                y = rng.uniform(0, th, 128)
                sigma, op = 4.0, 0.02
            s[:, 0], s[:, 1] = tox + x, toy + y
            s[:, 2] = s[:, 4] = 1.0 / (2 * sigma ** 2)
            s[:, 3] = rng.uniform(-0.1, 0.1, 128) / (2 * sigma ** 2)
            s[:, 5] = op
            s[:, 6:9] = rng.uniform(0, 1, (128, 3))
            s[:, 9] = rng.uniform(1, 3, 128)
    counts = np.array([mpt, mpt, 300, mpt], np.int32)
    slots[2, 300:] = 0.0
    params = torch.as_tensor(slots[..., :R].copy(), device=dev)
    return params, torch.as_tensor(counts, device=dev), tiles_x


def _tiled_params(params, tile, tiles_x):
    """K3's params_tiles [T, 16, K] with the splats of K2's slots, packed
    as tiled._build_tile_params packs them."""
    th, tw = tile
    T = params.shape[0]
    tid = torch.arange(T, device=params.device)
    mx = params[..., 0] - ((tid % tiles_x) * tw).float()[:, None]
    my = params[..., 1] - ((tid // tiles_x) * th).float()[:, None]
    A, B, C, op = params[..., 2], params[..., 3], params[..., 4], params[..., 5]
    zeros = torch.zeros_like(op)
    return torch.stack([
        -0.5 * A, -0.5 * C, -B, A * mx + B * my, C * my + B * mx,
        -(0.5 * A * mx * mx + 0.5 * C * my * my + B * mx * my), op, zeros,
        params[..., 6], params[..., 7], params[..., 8], torch.ones_like(op),
        zeros, zeros, zeros, zeros], dim=1).contiguous()


def _every_variant(mod, name, fwd, args, monkeypatch):
    """K2 or K3 (``fwd``) with its state at every built (cluster, pixels a
    thread), set through ``mod.name``; asserts that all give the same bits
    and that a repeat does; returns them."""
    first = None
    for variant in fs.VARIANTS:
        monkeypatch.setattr(mod, name, variant)
        with torch.no_grad():
            out, state = fwd(*args, return_state=True)
            again = fwd(*args)
        torch.cuda.synchronize()
        assert torch.equal(again, out), variant
        if first is None:
            first = out, state
        else:
            assert torch.equal(out, first[0]), variant
            assert torch.equal(state, first[1]), variant
    return first


def _k2_every_variant(args, monkeypatch):
    return _every_variant(fs, "K2_VARIANT", fs.composite_fwd, args,
                          monkeypatch)


def _k3_every_variant(args, monkeypatch):
    return _every_variant(tt, "K3_VARIANT", tt.tile_composite_fwd, args,
                          monkeypatch)


def _transmittance_close(state, ref_state, rel=1e-3):
    """The stored T row by row within ``rel`` of the plain T (relative: a
    block that stopped on its own vote leaves T orders of magnitude
    above the tile's)."""
    err = ((state[:, :, 0] - ref_state[:, :, 0]).abs()
           / ref_state[:, :, 0].clamp_min(1e-30)).max().item()
    assert err <= rel, err


@pytest.mark.parametrize("R", [9, 10])
def test_composite_fwd_vote_is_tile_wide_in_every_variant(cuda, R,
                                                          monkeypatch):
    """K2 on a tile whose pixels saturate at different chunks (each
    cluster block's share at its own chunk): every variant composites the
    tile up to the tile's early-out, as the plain version does."""
    params, counts, tiles_x = _banded_slots(cuda, R)
    args = (params, counts, 32, 32, tiles_x)
    with torch.no_grad():
        ref, ref_state = fs.composite_reference(*args, return_state=True)
        work = fs.composite_work(*args)
    assert work["tile_slots"].tolist() == [512, 512, 300, 1024]
    t1 = ref_state[0, 1, 0].reshape(32, 32)   # tile 0 after chunk 0
    assert bool((t1[:8] <= 1e-4).all()) and bool((t1[16:] > 1e-4).all())
    out, state = _k2_every_variant(args, monkeypatch)
    assert (out - ref).abs().max().item() <= 1e-3
    assert (state - ref_state).abs().max().item() <= 1e-3
    _transmittance_close(state, ref_state)


def test_tile_composite_fwd_vote_is_tile_wide_in_every_variant(cuda,
                                                               monkeypatch):
    """K3 on the same banded tiles (tiles._build_tile_params' packing):
    every variant composites each tile up to the tile's early-out."""
    params, counts, tiles_x = _banded_slots(cuda, 10)
    args = (_tiled_params(params, (32, 32), tiles_x), counts,
            tt._pixel_features(32, 32, cuda))
    with torch.no_grad():
        ref, ref_state = tt.tile_composite_reference(*args, return_state=True)
        work = tt.tile_composite_work(*args)
    assert work["tile_chunks"].tolist() == [4, 4, 3, 8]
    t1 = ref_state[0, 1, 0].reshape(32, 32)
    assert bool((t1[:8] <= 1e-4).all()) and bool((t1[16:] > 1e-4).all())
    out, state = _k3_every_variant(args, monkeypatch)
    assert (out - ref).abs().max().item() <= 1e-3
    assert (state - ref_state).abs().max().item() <= 1e-3
    _transmittance_close(state, ref_state)


@pytest.mark.parametrize("scene", ["bench", "heavy", "early_out"])
@pytest.mark.parametrize("R", [9, 10])
def test_composite_fwd_variants_match_plain(cuda, scene, R, monkeypatch):
    """K2 at every variant on the bench view (tiles at MPT = 1,024), a
    128² view with one full tile, and one whose tiles stop early: output
    and state against the plain version (1e-3, as K2_ATOL), and K2ᵇ fed
    the state against its plain replay (1e-4 of each row's scale)."""
    g, view, S = _scene_view(cuda, scene)
    with torch.no_grad():
        params, counts = fs._prepare_view(g, view, S, TAN, 1.0, 32, 32,
                                          32 if scene == "bench" else 16,
                                          1024, R == 10)
        assert params.shape[2] == R and int(counts.max()) == 1024
        args = (params, counts, 32, 32, S // 32)
        ref, ref_state = fs.composite_reference(*args, return_state=True)
        work = fs.composite_work(*args)
    if scene == "early_out":
        assert work["slots"] < int(counts.sum())
    out, state = _k2_every_variant(args, monkeypatch)
    assert (out - ref).abs().max().item() <= 1e-3
    assert (state - ref_state).abs().max().item() <= 1e-3
    go = torch.as_tensor(np.random.default_rng(3).normal(0, 1, out.shape),
                         dtype=torch.float32, device=cuda)
    with torch.no_grad():
        ours = fs.composite_bwd(params, counts, out, go, 32, 32, S // 32,
                                state=state)
        dref = fs.composite_bwd_reference(params, counts, out, go, 32, 32,
                                          S // 32)
    _assert_rows_close(ours, dref)


@pytest.mark.parametrize("scene", ["bench", "heavy", "early_out"])
def test_tile_composite_fwd_variants_match_plain(cuda, scene, monkeypatch):
    """K3 at every variant on the same views (K = 1,024): output and state
    against the plain version (1e-3, as K3_ATOL), and K3ᵇ fed the state
    against its plain replay (1e-4 of each row's scale)."""
    g, view, S = _scene_view(cuda, scene)
    with torch.no_grad():
        args = tt._prepare_view(g, view, S, TAN, 1.0, 32, 32, 1024)
        assert int(args[1].max()) == 1024
        ref, ref_state = tt.tile_composite_reference(*args, return_state=True)
        work = tt.tile_composite_work(*args)
    if scene == "early_out":
        assert bool((work["tile_chunks"] * 128 < args[1]).any())
    out, state = _k3_every_variant(args, monkeypatch)
    assert (out - ref).abs().max().item() <= 1e-3
    assert (state - ref_state).abs().max().item() <= 1e-3
    go = torch.as_tensor(np.random.default_rng(3).normal(0, 1, out.shape),
                         dtype=torch.float32, device=cuda)
    with torch.no_grad():
        ours = tt.tile_composite_bwd(*args, out, go, state)
        dref = tt.tile_composite_bwd_reference(*args, out, go)
    _rows_first_close(ours, dref)


@pytest.mark.parametrize("tile", [(16, 16), (8, 32), (8, 16), (4, 8)])
def test_compositor_variants_on_small_tiles(cuda, tile, monkeypatch):
    """Tiles of 256, 128 and 32 pixels, which the wrappers accept: each
    variant launches at flatsort.launch_shape's (cluster, pixels a
    thread), whole warps a block, and K2 and K3 match their plain
    versions with the same bits at every variant."""
    th, tw = tile
    P = th * tw
    for variant in fs.VARIANTS:
        cs, ppt = fs.launch_shape(P, variant)
        assert P % (32 * cs * ppt) == 0 and cs <= variant[0]
    params, counts, tiles_x = _banded_slots(cuda, 10, tile)
    args = (params, counts, th, tw, tiles_x)
    with torch.no_grad():
        ref, ref_state = fs.composite_reference(*args, return_state=True)
    out, state = _k2_every_variant(args, monkeypatch)
    assert (out - ref).abs().max().item() <= 1e-3
    assert (state - ref_state).abs().max().item() <= 1e-3
    targs = (_tiled_params(params, tile, tiles_x), counts,
             tt._pixel_features(th, tw, cuda))
    with torch.no_grad():
        tref, tref_state = tt.tile_composite_reference(*targs,
                                                       return_state=True)
    tout, tstate = _k3_every_variant(targs, monkeypatch)
    assert (tout - tref).abs().max().item() <= 1e-3
    assert (tstate - tref_state).abs().max().item() <= 1e-3


@pytest.mark.parametrize("return_state", [False, True])
def test_composite_kernels_count_their_work(cuda, return_state):
    """In a profiled run (``lgm_tpu_torch/trace.py``) K2 and K2ᵇ count
    their own work on the bench view: the pairs ``composite_work`` says,
    and the bytes the plain versions count (``flatsort._counted``,
    ``_bwd_work``). Without a profiler they count nothing."""
    from torch.profiler import ProfilerActivity, profile

    from lgm_tpu_torch import trace

    g, view, S = _bench_view(cuda)
    with torch.no_grad():
        params, counts = fs._prepare_view(g, view, S, TAN, 1.0, 32, 32, 32,
                                          1024, True)
        args = (params, counts, 32, 32, S // 32)
        work = fs.composite_work(*args)
        T, MPT, R = params.shape
        P = 32 * 32
        trace.reset()
        res = fs.composite_fwd(*args, return_state=return_state)
        assert trace.counters() == {}
        with profile(activities=[ProfilerActivity.CPU]):
            res = fs.composite_fwd(*args, return_state=return_state)
            if return_state:
                out, state = res
                fs.composite_bwd(params, counts, out, torch.ones_like(out),
                                 32, 32, S // 32, state=state)
        c = trace.counters()
        trace.reset()
    fixed = 4 * T * (1 + 8 * P + (MPT // 128 * 6 * P if return_state else 0))
    assert c["composite_fwd.launches"] == 1
    assert c["composite_fwd.pairs"] == work["pairs"] > 0
    assert c["composite_fwd.bytes"] == fixed + work["slots"] * R * 4
    if return_state:
        pairs, extra = fs._bwd_work(counts, state, P, R).tolist()
        assert c["composite_bwd.launches"] == 1
        assert c["composite_bwd.pairs"] == pairs == work["pairs"]
        assert c["composite_bwd.bytes"] == 4 * T * (1 + MPT * R) + extra


def test_composite_fwd_refuses_unaligned_params(cuda):
    """K2 copies a chunk's rows in 16-byte units: params that do not start
    on a 16-byte boundary are refused, not read past."""
    base = torch.zeros(4 * 128 * 9 + 1, device=cuda)
    params = base[1:].view(4, 128, 9)
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fs.composite_fwd(params, counts, 32, 32, 2)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_nano_trains_one_step_on_the_card(cuda, precision, monkeypatch):
    """The attention gate on the card: the nano preset (head dim 96/16 =
    6, which K1 does not take) trains one step in fp32 and in bf16 with a
    finite loss, every attention call on the dense route."""
    import lgm_tpu_torch.models.unet as unet_mod
    from lgm_tpu_torch import train
    from lgm_tpu_torch.config import get_config
    from lgm_tpu_torch.data.synthetic import make_batch

    routes = []
    for route, name in (("kernel", "mha"), ("dense", "dense_attention")):
        fn = getattr(unet_mod, name)
        monkeypatch.setattr(unet_mod, name, lambda *a, fn=fn, route=route: (
            routes.append(route), fn(*a))[1])
    opt = get_config("nano").replace(mixed_precision=precision)
    state = train.create_state(opt, cuda)
    data = train._batch_data(make_batch(np.random.default_rng(1), opt,
                                        device=cuda))
    m = train.train_step(state, data, torch.ones(3, device=cuda))
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
    assert routes and set(routes) == {"dense"}


# K1 in the diffusion U-Net: the joint self-attention of level 0 at 256²
# for MVDream (F = 4) and ImageDream (F = 5): BH = 2 (CFG) x 5 heads,
# S = F x 32², D = 64; in the finetune at its batch of 4 scenes, BH = 20,
# where K1ᵇ runs too.
DIFFUSION_K1_SHAPES = [(10, 4096, 64), (10, 5120, 64), (20, 4096, 64),
                       (20, 5120, 64)]
DIFFUSION_K1B_SHAPES = [(20, 4096, 64), (20, 5120, 64)]


@pytest.mark.parametrize("BH,S,D", DIFFUSION_K1_SHAPES)
def test_mha_fwd_kernel_at_diffusion_shapes(cuda, BH, S, D):
    rng = np.random.default_rng(S)
    q, k, v = (_bf16(rng, (BH, S, D), cuda) for _ in range(3))
    with torch.inference_mode():
        o, lse = mha_fwd(q, k, v, D ** -0.5, return_lse=True)
        ref, ref_lse = mha_reference(q, k, v, D ** -0.5, return_lse=True)
        again = mha_fwd(q, k, v, D ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    _close(o, ref)
    _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)


def test_spatial_transformer_k1_route_matches_dense(cuda, monkeypatch):
    """One level-0 SpatialTransformer3D at MVDream's widths (320 channels,
    5 heads of 64, context 1024) on a CFG pair of 4 frames at 32² (the
    joint sequence BH 10, S 4096): the K1 route against the same block
    with the gate forced dense, both bf16. Beyond the attention's own two
    rounding steps, the residual sums and the projections after it round
    the difference again: four bf16 steps of the output scale."""
    import lgm_tpu_torch.diffusion.mv_unet as mv

    torch.manual_seed(0)
    with cuda:
        st = mv.SpatialTransformer3D(320, 5, 64, 1024, torch.bfloat16).eval()
        x = torch.randn(8, 320, 32, 32).to(torch.bfloat16)
        ctx = torch.randn(8, 77, 1024)
    assert mv.kernel_route(torch.bfloat16, 2, 5, 4096, 4096, 64)
    with torch.inference_mode():
        before = mha_fwd.launches
        ours = st(x, ctx, 4)
        assert mha_fwd.launches == before + 1
        monkeypatch.setattr(mv, "kernel_route", lambda *a: False)
        dense = st(x, ctx, 4)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 1
    assert torch.isfinite(ours.float()).all()
    _close(ours, dense, 2.0 ** -6)


@pytest.mark.parametrize("BH,S,D", DIFFUSION_K1B_SHAPES)
def test_mha_bwd_kernel_at_diffusion_shapes(cuda, BH, S, D):
    """K1ᵇ at the finetune's shapes, fed K1's statistic, against its plain
    version (two rounding steps of each gradient's scale), and twice for
    the same bits."""
    rng = np.random.default_rng(S + BH)
    q, k, v, do = (_bf16(rng, (BH, S, D), cuda) for _ in range(4))
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, D ** -0.5, return_lse=True)
        ours = mha_bwd(q, k, v, o, do, D ** -0.5, lse)
        again = mha_bwd(q, k, v, o, do, D ** -0.5, lse)
        ref = mha_bwd_reference(q, k, v, o, do, D ** -0.5, lse)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), ours, ref, again):
        assert a.shape == b.shape, name
        _close(a, b)
        assert torch.equal(a, c), name


# (BH, Sq, Sk) of LGM big's S 1024 and 256 sites (B = 1 and bs2), a vp
# rank's lengths, the diffusion U-Net's level-0 shapes, and small odd ones
# (Sq 64 and 192: one-warpgroup blocks and the dK/dV kernels' 64-query
# tiles; Sq 64 against Sk 128: one tile of each).
ROUTE_SHAPES = [(16, 1024, 1024), (32, 1024, 1024), (32, 256, 256),
                (16, 256, 1024), (10, 4096, 4096), (20, 5120, 5120),
                (3, 512, 512), (2, 64, 256), (2, 192, 256), (2, 64, 128)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("BH,Sq,Sk", ROUTE_SHAPES)
def test_mha_each_route_matches_plain(cuda, D, BH, Sq, Sk):
    """Each head dim on the route ``ops/mha.py::route`` sends it (wgmma at
    D 32 and 64) at every shape: K1 (o and lse) and K1ᵇ (bf16, and f32
    dK/dV) against the plain versions, within K1_REL_TOL; a second call
    gives the same bits; the route's own count moves."""
    import lgm_tpu_torch.ops.mha as mha_mod

    route = mha_mod.route(D)
    assert route == "wgmma"
    rng = np.random.default_rng(BH + Sq + Sk)
    q, do = (_bf16(rng, (BH, Sq, D), cuda) for _ in range(2))
    k, v = (_bf16(rng, (BH, Sk, D), cuda) for _ in range(2))
    f0 = mha_fwd.route_launches[route]
    b0 = mha_bwd.route_launches[route]
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, 0.125, return_lse=True)
        again = mha_fwd(q, k, v, 0.125, return_lse=True)
        ref, ref_lse = mha_reference(q, k, v, 0.125, return_lse=True)
        _close(o, ref)
        _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse)
        for f32 in (False, True):
            ours = mha_bwd(q, k, v, o, do, 0.125, lse, dkv_f32=f32)
            twice = mha_bwd(q, k, v, o, do, 0.125, lse, dkv_f32=f32)
            plain = mha_bwd_reference(q, k, v, o, do, 0.125, lse,
                                      dkv_f32=f32)
            for a, b, c in zip(ours, plain, twice):
                assert a.dtype == b.dtype
                _close(a, b)
                assert torch.equal(a, c)
    torch.cuda.synchronize()
    assert mha_fwd.route_launches[route] == f0 + 2
    assert mha_bwd.route_launches[route] == b0 + 4


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("BH,Sq,Sk", [(10, 4096, 4096), (16, 256, 1024),
                                      (2, 192, 256), (32, 1024, 4096)])
def test_wgmma_kernels_agree_across_warpgroups(cuda, BH, Sq, Sk, D,
                                               monkeypatch):
    """The wgmma kernels' blocks of 1, 2 and (at D 32) 4 consumer
    warpgroups give the same bits, f32 dK/dV partials included: a row's
    arithmetic does not depend on the block."""
    import lgm_tpu_torch.ops.mha as mha_mod

    rng = np.random.default_rng(BH * Sq + Sk + D)
    q, do = (_bf16(rng, (BH, Sq, D), cuda) for _ in range(2))
    k, v = (_bf16(rng, (BH, Sk, D), cuda) for _ in range(2))
    outs = []
    with torch.no_grad():
        for nc in _blocks_built(D):
            monkeypatch.setattr(
                mha_mod, "warpgroups",
                lambda BH, rows, sms, D, nc=nc: nc
                if rows % (64 * nc) == 0 else 1)
            o, lse = mha_fwd(q, k, v, 0.125, return_lse=True)
            outs.append((o, lse, *mha_bwd(q, k, v, o, do, 0.125, lse),
                         *mha_bwd(q, k, v, o, do, 0.125, lse,
                                  dkv_f32=True)))
    torch.cuda.synchronize()
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_wgmma_kernels_spill_nothing(cuda):
    """``ptxas -v`` reports no spill bytes and no stack frame in any
    instantiation of the wgmma kernels (``chip_smoke.ptxas_summary`` of the
    build's log)."""
    from chip_smoke import ptxas_summary
    from lgm_tpu_torch.ops import _build

    libs = _build.build(["mha_fwd_wgmma", "mha_bwd_wgmma"])
    seen = 0
    for name, so in libs.items():
        report = ptxas_summary(so.with_name(so.name + ".log").read_text())
        for kernel, r in report.items():
            seen += 1
            assert (r["spill_stores"], r["spill_loads"],
                    r["stack_frame"]) == (0, 0, 0), (kernel, r)
    # K1 at 1, 2 and (D 32) 4 warpgroups; K1ᵇ: dq at each, dK/dV at each
    # and both query tiles.
    assert seen == (3 + 3 + 6) + (2 + 2 + 4)


def test_diffusion_finetune_step_on_the_card(cuda):
    """The finetune's entry point on the card: DiffusionTrainer at
    tiny-test (bf16 compute) takes a step on cuda from from_config, whose
    zero output layers give the loss E||ε||² ≈ 1."""
    from lgm_tpu_torch.diffusion.data import blender_condition
    from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline
    from lgm_tpu_torch.diffusion.train import DiffusionTrainer

    rng = np.random.default_rng(0)
    data = {"images": rng.uniform(0, 1, (4, 4, 32, 32, 3)).astype(np.float32),
            "camera": np.stack([np.stack([blender_condition(10.0, 90.0 * f)
                                          for f in range(4)])] * 4),
            "prompts": ["a test object"] * 4}
    pipe = MVDreamPipeline.from_config("tiny-test", device="cuda")
    trainer = DiffusionTrainer(pipe, lr=1e-3, warmup=1, cond_drop=0.0)
    m = trainer.train_step(data)
    torch.cuda.synchronize()
    assert all(p.is_cuda for p in trainer.optimizer.params)
    assert 0.85 < float(m["loss"]) < 1.15
    assert np.isfinite(float(m["gnorm"]))


# The mesh converter on the card (the trirast rasterizer is plain PyTorch;
# its teacher renders are K2). rasterize on CUDA against its CPU path: the
# edge functions' products may contract to FMAs on the card, so a pixel on
# a shared edge may go to the other face; at least 99.9% of face ids equal,
# and where they are, barycentrics within 1e-4.
RASTER_EQUAL_SHARE = 0.999


def _sphere_mesh(n=28, r=0.6, seed=3):
    from lgm_tpu_torch import native

    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    v, f = native.marching_cubes(
        (10 * (r - np.sqrt(X**2 + Y**2 + Z**2))).astype(np.float32), 0.0)
    v = (v / (n - 1) * 2 - 1).astype(np.float32)
    f = f[np.random.default_rng(seed).permutation(len(f))]
    return v, f


@pytest.mark.parametrize("S,cap", [(256, 1024), (128, 64)])
def test_rasterize_on_the_card_matches_cpu(cuda, S, cap):
    from lgm_tpu_torch.ops import trirast

    v, f = _sphere_mesh()
    vp = camera.build_camera_inputs(camera.orbit_camera(
        15.0, 35.0, 1.5)[None], FOVY, 0.5, 2.5)["cam_view_proj"][0]
    clip = trirast.project_vertices(torch.as_tensor(v),
                                    torch.as_tensor(vp, dtype=torch.float32))
    faces = torch.as_tensor(f, dtype=torch.int64)
    ref = trirast.rasterize(clip, faces, S, max_faces_per_tile=cap)
    out = trirast.rasterize(clip.to(cuda), faces.to(cuda), S,
                            max_faces_per_tile=cap)
    fid, ref_fid = out["face_id"].cpu(), ref["face_id"]
    same = fid == ref_fid
    assert same.float().mean().item() >= RASTER_EQUAL_SHARE
    if cap == 1024:  # a cap of 64 drops most of the covering faces
        assert (ref_fid >= 0).float().mean().item() > 0.2
    torch.testing.assert_close(out["tile_faces"].cpu(), ref["tile_faces"])
    err = (out["bary"].cpu() - ref["bary"])[same].abs().max().item()
    assert err <= 1e-4


def test_tiny_conversion_on_the_card(cuda, tmp_path):
    """A tiny Converter.run on the card: one K2 launch per teacher view
    (fit_nerf's, fit_mesh's and fit_texture's iterations), a .glb that
    loads."""
    from lgm_tpu_torch.config import get_config
    from lgm_tpu_torch.convert import Converter
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.io.mesh import load_glb

    g = sample_scene(np.random.default_rng(0), 4096)
    conv = Converter(get_config("nano"), g, seed=0, device="cuda")
    fs.composite_fwd.launches = 0
    out = str(tmp_path / "m.glb")
    conv.run(out, nerf_iters=64, mesh_iters=8, tex_iters=8,
             grid_resolution=64, target_faces=5000)
    assert fs.composite_fwd.launches == 64 + 8 + 8
    verts, faces, uv, tex = load_glb(out)
    assert len(verts) == len(conv.verts) and len(faces) == len(conv.faces)
    assert uv is not None and tex[:8] == b"\x89PNG\r\n\x1a\n"
    for stage in ("nerf", "mesh", "texture"):
        assert np.isfinite(conv.losses[stage]).all()


# K1 and K1ᵇ on f32 inputs (csrc/mha_fwd_f32.cu, mha_bwd_f32.cu: 3xTF32 on
# wgmma fed by TMA from the split pass's planes, csrc/mha_split_tf32.cu),
# held to the plain versions at f32, exact softmax attention
# with f32 matmuls (TF32 off). The kernels' products are about 2^-22 of
# |a b| from f32 products and the sums run in other orders: o, dq, dk and
# dv within 1e-5 of their largest |value|; the statistic as the bf16
# kernel's (1e-5 of max(1, |L|)). LGM big's three site shapes at B = 1
# (BH 16) and bs2 (BH 32), the preset's batch of 8 at S 4096 (BH 128), and
# two small odd ones.
K1_F32_REL_TOL = 1e-5
MHA_F32_SHAPES = [(16, 4096, 32), (32, 4096, 32), (16, 1024, 64),
                  (32, 1024, 64), (16, 256, 64), (32, 256, 64),
                  (128, 4096, 32), (3, 512, 64), (3, 256, 32)]


def _f32(rng, shape, dev):
    return torch.as_tensor(rng.normal(0, 1, shape), dtype=torch.float32,
                           device=dev)


@pytest.fixture
def full_f32(cuda, monkeypatch):
    """The plain versions' matmuls in full f32 (PyTorch's default, stated)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return cuda


@pytest.mark.parametrize("BH,S,D", MHA_F32_SHAPES)
def test_mha_f32_kernels_match_plain(full_f32, BH, S, D):
    """f32 K1 (o and its statistic) and K1ᵇ against their plain versions;
    outputs f32; a second call gives the same bits; the f32 wrappers count
    the launches, the bf16 ones do not move."""
    cuda = full_f32
    rng = np.random.default_rng(BH + S + D)
    q, k, v, do = (_f32(rng, (BH, S, D), cuda) for _ in range(4))
    scale = D ** -0.5
    counts = (mha_fwd_f32.launches, mha_bwd_f32.launches, mha_fwd.launches,
              mha_bwd.launches)
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, scale, return_lse=True)
        again = mha_fwd(q, k, v, scale, return_lse=True)
        ref, ref_lse = mha_reference(q, k, v, scale, return_lse=True)
        grads = mha_bwd(q, k, v, o, do, scale, lse)
        twice = mha_bwd(q, k, v, o, do, scale, lse)
        plain = mha_bwd_reference(q, k, v, o, do, scale, lse)
    torch.cuda.synchronize()
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (BH, S)
    _close(o, ref, K1_F32_REL_TOL)
    _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    for a, b, c in zip(grads, plain, twice):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _close(a, b, K1_F32_REL_TOL)
        assert torch.equal(a, c)
    assert (mha_fwd_f32.launches, mha_bwd_f32.launches, mha_fwd.launches,
            mha_bwd.launches) == (counts[0] + 2, counts[1] + 2, *counts[2:])


@pytest.mark.parametrize("BH,S,D,vp", MHA_VP_SHAPES)
def test_mha_f32_kernels_at_a_vp_ranks_lengths(full_f32, BH, S, D, vp):
    """Each rank's f32 K1 (Sq = S/vp, Sk = S) and K1ᵇ (f32 dK/dV partials)
    against their plain versions; the ranks' o, lse and dq rows bit for
    bit the full-length call's; the sum of the ranks' dK and dV within
    1e-5 of the full call's largest |value| (f32 sums grouped otherwise)."""
    cuda = full_f32
    rng = np.random.default_rng(S + D + vp)
    q, k, v, do = (_f32(rng, (BH, S, D), cuda) for _ in range(4))
    scale = D ** -0.5
    n = S // vp
    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, scale, return_lse=True)
        dq, dk, dv = mha_bwd(q, k, v, o, do, scale, lse)
        dk_sum = torch.zeros_like(dk)
        dv_sum = torch.zeros_like(dv)
        for r in range(vp):
            rows = slice(r * n, (r + 1) * n)
            q_r, do_r = q[:, rows].contiguous(), do[:, rows].contiguous()
            o_r, lse_r = mha_fwd(q_r, k, v, scale, return_lse=True)
            ref, ref_lse = mha_reference(q_r, k, v, scale, return_lse=True)
            _close(o_r, ref, K1_F32_REL_TOL)
            _close(lse_r, ref_lse, K1_LSE_REL_TOL, 1.0)
            assert torch.equal(o_r, o[:, rows])
            assert torch.equal(lse_r, lse[:, rows])
            ours = mha_bwd(q_r, k, v, o_r, do_r, scale, lse_r, dkv_f32=True)
            ref = mha_bwd_reference(q_r, k, v, o_r, do_r, scale, lse_r,
                                    dkv_f32=True)
            for a, b in zip(ours, ref):
                assert a.dtype == torch.float32 and a.shape == b.shape
                _close(a, b, K1_F32_REL_TOL)
            assert torch.equal(ours[0], dq[:, rows])
            dk_sum += ours[1]
            dv_sum += ours[2]
    torch.cuda.synchronize()
    _close(dk_sum, dk, K1_F32_REL_TOL)
    _close(dv_sum, dv, K1_F32_REL_TOL)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("BH,Sq,Sk", [(16, 1024, 1024), (2, 192, 256),
                                      (4, 128, 512)])
def test_mha_f32_kernels_agree_across_block_shapes(full_f32, BH, Sq, Sk, D,
                                                   monkeypatch):
    """The f32 kernels' blocks of one consumer warpgroup and of the most
    each kernel takes at these lengths (K1 4 at D 32, else 2; the dq and
    dK/dV kernels 2 at D 32) give the same bits: a row's arithmetic does
    not depend on the block."""
    import lgm_tpu_torch.ops.mha as mha_mod

    cuda = full_f32
    rng = np.random.default_rng(BH * Sq + Sk + D)
    q, do = (_f32(rng, (BH, Sq, D), cuda) for _ in range(2))
    k, v = (_f32(rng, (BH, Sk, D), cuda) for _ in range(2))

    def widest(rows, most):
        return next(n for n in (4, 2, 1) if n <= most and rows % (64 * n) == 0)

    outs = []
    with torch.no_grad():
        for plan in (dict(fwd=1, dq=1, dkv=1),
                     dict(fwd=widest(Sq, 4 if D == 32 else 2),
                          dq=widest(Sq, 2 if D == 32 else 1),
                          dkv=widest(Sk, 2 if D == 32 else 1))):
            monkeypatch.setattr(mha_mod, "f32_warpgroups",
                                lambda *a, plan=plan: plan)
            o, lse = mha_fwd(q, k, v, 0.125, return_lse=True)
            outs.append((o, lse, *mha_bwd(q, k, v, o, do, 0.125, lse)))
    torch.cuda.synchronize()
    ref, ref_lse = mha_reference(q, k, v, 0.125, return_lse=True)
    _close(outs[0][0], ref, K1_F32_REL_TOL)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("BH,R,D", [(16, 4096, 32), (3, 256, 64),
                                    (2, 96, 32), (4, 1024, 64)])
def test_split_kernel_matches_plain_bit_for_bit(cuda, BH, R, D):
    """The split pass (csrc/mha_split_tf32.cu) against its plain version
    (split_tf32_reference), bit for bit: row-major and transposed halves,
    each kind alone, four operands of two lengths in one launch."""
    rng = np.random.default_rng(BH + R + D)
    xs = [_f32(rng, (BH, R, D), cuda) * 10.0 for _ in range(3)]
    xs.append(_f32(rng, (BH, 2 * R, D), cuda))
    asks = [(True, True), (True, False), (False, True), (True, True)]
    before = mha_split_tf32.launches
    got = mha_split_tf32([(x, r, c) for x, (r, c) in zip(xs, asks)])
    torch.cuda.synchronize()
    assert mha_split_tf32.launches == before + 1
    for x, (r, c), planes in zip(xs, asks, got):
        want = split_tf32_reference(x, r, c)
        assert planes.keys() == want.keys()
        for key in want:
            assert planes[key].shape == want[key].shape
            assert torch.equal(planes[key].view(torch.int32),
                               want[key].view(torch.int32)), key


def test_f32_kernels_spill_nothing(cuda):
    """``ptxas -v`` reports no spill bytes and no stack frame in any
    instantiation of the f32 kernels and their split pass."""
    from chip_smoke import ptxas_summary
    from lgm_tpu_torch.ops import _build

    libs = _build.build(["mha_fwd_f32", "mha_bwd_f32", "mha_split_tf32"])
    seen = 0
    for name, so in libs.items():
        report = ptxas_summary(so.with_name(so.name + ".log").read_text())
        for kernel, r in report.items():
            seen += 1
            assert (r["spill_stores"], r["spill_loads"],
                    r["stack_frame"]) == (0, 0, 0), (kernel, r)
    # K1 5, the dq and dK/dV kernels 3 each, the split pass 2 (D 32, 64).
    assert seen == 5 + 3 + 3 + 2


def test_f32_libraries_run_tf32_hgmma(cuda):
    """Every kernel of the f32 libraries multiplies on wgmma with TF32
    operands (SASS ``HGMMA.64xNx8.F32.TF32``), and none keeps Ampere's
    m16n8k8 mma.sync (``HMMA.1688``): ``cuobjdump -sass`` as
    ``scripts/sass_counts.py`` runs it. (ptxas adds two ``HGMMA...F16``
    of its own to each kernel, which multiply nothing of ours.)"""
    from lgm_tpu_torch.ops import _build

    libs = _build.build(["mha_fwd_f32", "mha_bwd_f32"])
    kernels = 0
    for name, so in libs.items():
        counts = _build.sass_mma_counts(so)
        assert counts, name
        for kernel, c in counts.items():
            kernels += 1
            assert c["HGMMA_TF32"] > 0 and c["HMMA_1688"] == 0, (kernel, c)
    # K1 at 1, 2, 4 (D 32) and 1, 2 (D 64) warpgroups; the dq and dK/dV
    # kernels at 1 and 2 (D 32) and 1 (D 64).
    assert kernels == 5 + 3 + 3


def test_mha_f32_autograd_launches_both_kernels(full_f32):
    """mha on f32 tensors that record a graph: f32 K1 forward, f32 K1ᵇ
    backward, the gradients the plain versions' and autograd's own
    softmax-attention gradient."""
    cuda = full_f32
    rng = np.random.default_rng(4)
    q, k, v = (_f32(rng, (2, 512, 64), cuda).requires_grad_()
               for _ in range(3))
    g = _f32(rng, (2, 512, 64), cuda)
    f0, b0 = mha_fwd_f32.launches, mha_bwd_f32.launches
    out = mha(q, k, v, 0.125)
    lse = out.grad_fn.saved_tensors[4]
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (mha_fwd_f32.launches, mha_bwd_f32.launches) == (f0 + 1, b0 + 1)
    assert out.dtype == q.grad.dtype == torch.float32
    with torch.no_grad():
        o, ref_lse = mha_reference(q, k, v, 0.125, return_lse=True)
        _close(lse, ref_lse, K1_LSE_REL_TOL, 1.0)
        ref = mha_bwd_reference(q, k, v, o, g, 0.125, ref_lse)
    qa, ka, va = (x.detach().clone().requires_grad_() for x in (q, k, v))
    (torch.softmax(qa @ ka.transpose(1, 2) * 0.125, dim=-1) @ va
     * g).sum().backward()
    for a, b, c in zip((q.grad, k.grad, v.grad), ref,
                       (qa.grad, ka.grad, va.grad)):
        _close(a, b, K1_F32_REL_TOL)
        _close(a, c, K1_F32_REL_TOL)


def test_mha_f32_kernels_refuse_what_they_do_not_take(cuda):
    """The f32 wrappers raise on what the f32 kernels do not take: another
    dtype, a tensor of another dtype in the call, D 48, Sk not a multiple
    of 128, Sq not a multiple of 64; nothing is converted or sent dense."""
    f = torch.zeros(1, 128, 32, device=cuda)
    lse = torch.zeros(1, 128, device=cuda)
    b = f.to(torch.bfloat16)
    with pytest.raises(ValueError):
        mha_fwd_f32(b, b, b, 1.0)  # bf16
    with pytest.raises(ValueError):
        mha_fwd_f32(f, b, f, 1.0)  # a bf16 k
    with pytest.raises(ValueError):
        mha_bwd_f32(f, f, f, f, b, 1.0, lse)  # a bf16 dO
    with pytest.raises(ValueError):
        mha_bwd_f32(f, f, f, f, f, 1.0, lse.double())  # lse not f32
    x = torch.zeros(1, 128, 48, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(x, x, x, 1.0)  # D = 48
    with pytest.raises(ValueError):
        mha_bwd(x, x, x, x, x, 1.0, lse)
    w = torch.zeros(1, 192, 32, device=cuda)
    with pytest.raises(ValueError):
        mha_fwd(f[:, :64].contiguous(), w, w, 1.0)  # Sk % 128
    with pytest.raises(ValueError):
        mha_fwd(f[:, :32].contiguous(), f, f, 1.0)  # Sq % 64
    with pytest.raises(ValueError):
        mha_fwd(f, f, f, -1.0)  # scale <= 0
    z = f.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        mha_fwd(z, z, z, 1.0)


# ---------------------------------------------------------------------------
# The projection kernels (csrc/project_fwd.cu, project_bwd.cu): the forward
# gives project_gaussians's bits; the backward is the closed-form VJP
# ---------------------------------------------------------------------------

# Max abs error of each gradient column within this share of the column's
# largest |value|: f32 sums in other orders and contracted into fmas
# (project_gaussians_bwd_reference reads at most 2e-6 against autograd on
# the CPU).
PROJECT_BWD_COL_TOL = 2.0 ** -15


def _projection_scene(cuda, cam):
    """65,536 splats of ``sample_scene`` at 512² through a camera of the
    train cell (a supervision view of ``sample_poses``) or of the orbit."""
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_poses, sample_scene
    from lgm_tpu_torch.infer import orbit_video_cameras

    opt = CONFIGS["big"]
    rng = np.random.default_rng(21)
    g = sample_scene(rng, 65536)
    if cam == "train":
        views = camera.build_camera_inputs(sample_poses(rng, opt), opt.fovy,
                                           opt.znear, opt.zfar)["cam_view"]
        view = views[opt.num_input_views + 1]
    else:
        view = orbit_video_cameras(opt, 180)["cam_view"][37]
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    return (torch.as_tensor(g, device=cuda),
            torch.as_tensor(view, dtype=torch.float32, device=cuda),
            opt.output_size, tan)


def _assert_projected_equal(ours, ref):
    for field in pj.Projected._fields:
        a, b = getattr(ours, field), getattr(ref, field)
        assert not (b.is_floating_point() and b.isnan().any()), field
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), (
            field, int((a != b).sum()),
            float((a.double() - b.double()).abs().max()))


@pytest.mark.parametrize("with_depth", [False, True])
@pytest.mark.parametrize("cam", ["train", "orbit"])
def test_project_fwd_kernel_is_plain_bit_for_bit(cuda, cam, with_depth):
    """The forward kernel gives every field of ``project_gaussians`` bit
    for bit on the train cell's scene shape, and the binning gives the
    same FlatBins from either."""
    g, view, S, tan = _projection_scene(cuda, cam)
    before = pj.project_fwd.launches
    with torch.no_grad():
        ours = pj.project_fwd(g, view, S, tan, 1.0, with_depth)
        ref = pj.project_gaussians(g, view, S, tan, 1.0, with_depth)
        torch.cuda.synchronize()
        assert pj.project_fwd.launches == before + 1
        _assert_projected_equal(ours, ref)
        assert int(ref.valid.sum()) > 10000
        tiles = S // 32
        for a, b in zip(fs._flat_binning(ours, tiles, tiles, 32, 32, 16),
                        fs._flat_binning(ref, tiles, tiles, 32, 32, 16)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_project_fwd_kernel_is_plain_on_every_branch(cuda, name):
    """Bit for bit on the scenes that reach each branch: behind the near
    plane, past and on the frustum clamps, det <= 0, opacity below
    ALPHA_MIN, un-normalised quaternions, scale_modifier != 1."""
    g, view, mod = case(name)
    g, view = torch.as_tensor(g, device=cuda), torch.as_tensor(view,
                                                               device=cuda)
    for with_depth in (False, True):
        with torch.no_grad():
            _assert_projected_equal(
                pj.project_fwd(g, view, SIZE, TAN, mod, with_depth),
                pj.project_gaussians(g, view, SIZE, TAN, mod,
                                     with_depth))


def _project_grads(g, view, mod, with_depth, seed=0):
    """(kernel, plain VJP, autograd of the plain chain) for seeded
    cotangents of the slot rows, handed back transposed as flatsort's
    permute does, and of the depth output."""
    N, R = g.shape[0], 10 if with_depth else 9
    gen = torch.Generator(device=g.device).manual_seed(seed)
    g_attrs = torch.randn(N, R, generator=gen, device=g.device).T
    g_depth = torch.randn(N, generator=gen, device=g.device)
    ours = pj.project_bwd(g, view, SIZE, TAN, mod, g_attrs, g_depth)
    ref = pj.project_gaussians_bwd_reference(g, view, SIZE, TAN, mod,
                                             g_attrs, g_depth)
    gl = g.clone().requires_grad_()
    p = pj.project_gaussians(gl, view, SIZE, TAN, mod, with_depth)
    ((p.attrs_t * g_attrs).sum() + (p.depth * g_depth).sum()).backward()
    return ours, ref, gl.grad


def _columns_close(ours, ref, tol=PROJECT_BWD_COL_TOL):
    scale = ref.abs().amax(dim=0)
    err = (ours - ref).abs().amax(dim=0)
    assert torch.all(err <= tol * scale), (err / scale).tolist()


@pytest.mark.parametrize("name", CASES)
def test_project_bwd_kernel_matches_plain(cuda, name):
    """The backward kernel against ``project_gaussians_bwd_reference`` and
    autograd of the plain chain on the card, with and without the depth
    row, on the scenes that reach each branch; without the depth output's
    cotangent and with no cotangent at all."""
    g, view, mod = case(name)
    g, view = torch.as_tensor(g, device=cuda), torch.as_tensor(view,
                                                               device=cuda)
    for with_depth in (False, True):
        before = pj.project_bwd.launches
        ours, ref, auto = _project_grads(g, view, mod, with_depth)
        torch.cuda.synchronize()
        assert pj.project_bwd.launches == before + 1
        assert torch.isfinite(ours).all()
        _columns_close(ours, ref)
        _columns_close(ours, auto)
    g_attrs = torch.randn(9, g.shape[0], device=cuda)
    _columns_close(
        pj.project_bwd(g, view, SIZE, TAN, mod, g_attrs),
        pj.project_gaussians_bwd_reference(g, view, SIZE, TAN, mod,
                                           g_attrs))
    assert torch.all(pj.project_bwd(g, view, SIZE, TAN, mod) == 0)


def test_project_bwd_kernel_is_deterministic(cuda):
    """One thread a splat and no atomics: the same bits on every call, at
    the train cell's scene shape."""
    g, view, S, tan = _projection_scene(cuda, "train")
    g_attrs = torch.randn(g.shape[0], 9, device=cuda).T
    runs = [pj.project_bwd(g, view, S, tan, 1.0, g_attrs) for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    ref = pj.project_gaussians_bwd_reference(g, view, S, tan, 1.0, g_attrs)
    _columns_close(runs[0], ref)


@pytest.mark.parametrize("with_depth", [False, True])
def test_render_grad_launches_projection_kernels_once_a_view(cuda,
                                                             with_depth):
    """A render_views forward and backward on the card launches the
    forward and the backward projection kernel once a view, and gives the
    CPU path's gradient."""
    from lgm_tpu_torch.ops.gsplat.api import render_views

    rng = np.random.default_rng(8)
    g = torch.as_tensor(_scene(2000, rng)[None], device=cuda)
    views = torch.as_tensor(np.stack([camera.build_camera_inputs(
        camera.orbit_camera(10, az, 1.5)[None], FOVY, 0.5, 2.5)["cam_view"][0]
        for az in (30, 150, 270)])[None], device=cuda)
    tgt = torch.rand(1, 3, 128, 128, 3, device=cuda)

    def loss(out, tgt):
        value = ((out["image"] - tgt) ** 2).mean()
        if with_depth:
            value = value + out["depth"].mean()
        return value

    f0, b0 = pj.project_fwd.launches, pj.project_bwd.launches
    gt = g.clone().requires_grad_()
    loss(render_views(gt, views, 128, TAN, with_depth=with_depth, dup=32),
         tgt).backward()
    torch.cuda.synchronize()
    assert pj.project_fwd.launches == f0 + 3
    assert pj.project_bwd.launches == b0 + 3
    with torch.inference_mode():
        render_views(g, views, 128, TAN, with_depth=with_depth, dup=32)
    assert pj.project_fwd.launches == f0 + 6
    assert pj.project_bwd.launches == b0 + 3
    gp = g.cpu().requires_grad_()
    loss(render_views(gp, views.cpu(), 128, TAN, with_depth=with_depth,
                      dup=32), tgt.cpu()).backward()
    err = (gt.grad.cpu() - gp.grad).abs().max().item()
    assert err <= 1e-3 * gp.grad.abs().max().item(), err


def test_project_kernels_refuse_what_they_do_not_take(cuda):
    g, view, mod = case("orbit")
    g, view = torch.as_tensor(g, device=cuda), torch.as_tensor(view,
                                                               device=cuda)
    args = (SIZE, TAN, mod)
    wide = torch.zeros(len(g), 28, device=cuda)
    wide[:, ::2] = g
    bad_inputs = [(g.double(), view), (wide[:, ::2], view),
                  (g[:, :13].contiguous(), view), (g, view.double()),
                  (g, view[:3].contiguous()), (g, view.T), (g.cpu(), view)]
    for gg, vv in bad_inputs:
        with pytest.raises(ValueError):
            pj.project_fwd(gg, vv, *args)
        with pytest.raises(ValueError):
            pj.project_bwd(gg, vv, *args)
    g_attrs = torch.zeros(9, len(g), device=cuda)
    for bad in (g_attrs[:8], g_attrs.double(), g_attrs.cpu(),
                torch.zeros(11, len(g), device=cuda)):
        with pytest.raises(ValueError):
            pj.project_bwd(g, view, *args, g_attrs=bad)
    for bad in (torch.zeros(len(g) + 1, device=cuda),
                torch.zeros(len(g), 2, device=cuda)[:, 0]):
        with pytest.raises(ValueError):
            pj.project_bwd(g, view, *args, g_depth=bad)
    view_grad = view.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        pj.project(g.clone().requires_grad_(), view_grad, *args)
    with pytest.raises(NotImplementedError):
        pj.project_fwd(g, view_grad, *args)


def test_pipeline_loads_cuda_tensors_as_they_are(cuda):
    """``MVDreamPipeline.load_state_dicts`` takes weights that live on the
    card (no host round trip), the same weights as from the host."""
    from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline

    src = MVDreamPipeline.from_config("tiny-test-ip", seed=1, device="cpu")
    sds = {name: {k: v.to(cuda) for k, v in m.state_dict().items()}
           for name, m in src.modules().items()}
    dst = MVDreamPipeline.from_config("tiny-test-ip", seed=2, device="cuda")
    dst.load_state_dicts(sds)
    for name, module in dst.modules().items():
        want = src.modules()[name].state_dict()
        for k, v in module.state_dict().items():
            assert v.device.type == "cuda"
            assert torch.equal(v.cpu(), want[k]), (name, k)


# LPIPS in the loss as one replayed CUDA graph a chunk
# (``models/lpips.py::GraphedFold``): LGM big's B x V = 64 pairs, rendered
# at 512² and resized to 256² in bf16, as in its train step.
LPIPS_BIG = (8, 8, 512)


@pytest.fixture
def lpips_model(cuda, monkeypatch):
    """nano's LGMWithLoss in bf16 with LPIPS on (the whole VGG-16 tower,
    seeded) on the card. cuDNN keeps to its deterministic algorithms, so
    that two runs of one convolution give the same bits."""
    from lgm_tpu_torch.config import get_config
    from lgm_tpu_torch.models.lgm import LGMWithLoss

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    opt = get_config("nano").replace(lambda_lpips=1.0)
    return LGMWithLoss(opt, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).to(cuda)


def _lpips_images(cuda, B, V, S, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    pred = torch.rand(B, V, S, S, 3, generator=gen, device=cuda)
    gt = torch.rand(B, V, S, S, 3, generator=gen, device=cuda)
    return pred.requires_grad_(), gt


def _lpips_loss_and_grad(model, pred, gt, lpips_fn=None):
    value = (lpips_fn or type(model)._lpips)(model, pred, gt)
    value.backward()
    grad, pred.grad = pred.grad, None
    torch.cuda.synchronize()
    return value.detach(), grad


def _eager_folds(model, monkeypatch):
    """Make ``model`` run each chunk's fold eagerly, as on the CPU."""
    from lgm_tpu_torch.models.lpips import grad_seed, value_and_grad

    def eager(gt, pr, n):
        fn = functools.partial(lgm_mod._lpips_nchw, model.lpips_loss)
        return functools.partial(value_and_grad, fn,
                                 seed=grad_seed(len(pr), n, pr.device))

    monkeypatch.setattr(model, "_lpips_graph", eager)


def _assert_same(ours, want):
    assert torch.equal(ours[0], want[0])
    assert torch.equal(ours[1], want[1])


def test_lpips_graph_is_the_eager_fold_bit_for_bit(lpips_model, cuda,
                                                   monkeypatch):
    """64 pairs at 256²: the replays give the eager fold's loss and
    prediction gradient bit for bit, and the checkpointed loop's."""
    from test_torch_lpips_fold import reference_lpips

    pred, gt = _lpips_images(cuda, *LPIPS_BIG)
    graphed = _lpips_loss_and_grad(lpips_model, pred, gt)
    assert len(lpips_model._lpips_graphs) == 1
    _assert_same(_lpips_loss_and_grad(lpips_model, pred, gt), graphed)
    ref = _lpips_loss_and_grad(lpips_model, pred, gt, reference_lpips)
    _eager_folds(lpips_model, monkeypatch)
    _assert_same(_lpips_loss_and_grad(lpips_model, pred, gt), graphed)
    _assert_same(ref, graphed)
    assert graphed[1].abs().max() > 0


def test_lpips_second_chunk_shape_captures_a_second_graph(lpips_model,
                                                          cuda, monkeypatch):
    from lgm_tpu_torch import trace
    from torch.profiler import ProfilerActivity, profile

    trace.reset()
    big = _lpips_images(cuda, *LPIPS_BIG)
    small = _lpips_images(cuda, 2, 3, 512, seed=1)   # 6 pairs: chunks of 2
    with profile(activities=[ProfilerActivity.CPU]):
        ours = [_lpips_loss_and_grad(lpips_model, *x) for x in (big, small)]
    keys = sorted(k[0] for k in lpips_model._lpips_graphs)
    assert keys == [(2, 3, 256, 256), (4, 3, 256, 256)]
    assert trace.counters() == {"lpips.graph_captures": 2,
                                "lpips.graph_replays": 16 + 3}
    trace.reset()
    _eager_folds(lpips_model, monkeypatch)
    for x, got in zip((big, small), ours):
        _assert_same(got, _lpips_loss_and_grad(lpips_model, *x))


def _pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the memory pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def test_lpips_graphs_share_one_memory_pool(lpips_model, cuda):
    """A second key's fold is captured into the first's memory pool: a
    second fold at LGM big's chunk (8 pairs, another mean) adds its
    outputs to the pool, not a second chunk's activations."""
    _lpips_loss_and_grad(lpips_model, *_lpips_images(cuda, *LPIPS_BIG))
    first, = lpips_model._lpips_graphs.values()
    one = _pool_bytes(first.pool())
    assert one > 100 * 2**20, one   # a chunk's VGG activations
    _lpips_loss_and_grad(lpips_model, *_lpips_images(cuda, 2, 4, 512, seed=1))
    graphs = list(lpips_model._lpips_graphs.values())
    assert len(graphs) == 2
    assert all(g.pool() == first.pool() for g in graphs)
    assert _pool_bytes(first.pool()) < 1.25 * one


def test_lpips_graph_replays_sixteen_a_step_under_the_profiler(lpips_model,
                                                               cuda):
    """Once captured, LGM big's LPIPS forward and backward is 16 replays
    and under 150 host launch calls (the loop it replaced made ~12,000)."""
    from lgm_tpu_torch import trace
    from torch.profiler import ProfilerActivity, profile

    pred, gt = _lpips_images(cuda, *LPIPS_BIG)
    _lpips_loss_and_grad(lpips_model, pred, gt)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _lpips_loss_and_grad(lpips_model, pred, gt)
    assert trace.counters() == {"lpips.graph_replays": 16}
    trace.reset()
    calls = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith(("cudaLaunch", "cuLaunch",
                                      "cudaGraphLaunch", "cudaMemcpy",
                                      "cudaMemset"))]
    assert calls.count("cudaGraphLaunch") == 16
    assert len(calls) < 150, len(calls)


def test_lpips_graph_sees_a_parameter_copied_in_place(lpips_model, cuda,
                                                      monkeypatch):
    pred, gt = _lpips_images(cuda, *LPIPS_BIG)
    before = _lpips_loss_and_grad(lpips_model, pred, gt)
    graph, = lpips_model._lpips_graphs.values()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for conv in lpips_model.lpips_loss.vgg.values():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * conv.weight.std().item())
    after = _lpips_loss_and_grad(lpips_model, pred, gt)
    assert list(lpips_model._lpips_graphs.values()) == [graph]
    assert not torch.equal(after[0], before[0])
    _eager_folds(lpips_model, monkeypatch)
    _assert_same(after, _lpips_loss_and_grad(lpips_model, pred, gt))
