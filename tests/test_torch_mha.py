"""Port's attention (K1's and K1ᵇ's plain versions, taken by mha_fwd and
mha_bwd on CPU tensors) vs lgm_tpu's K-resident Pallas kernels and their
VJP, run in interpret mode: at equal query and key lengths, and at a vp
rank's S/vp queries against S keys; in bf16, and in f32, where the plain
versions (those of the f32 kernels) are exact softmax attention."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops.mha import mha_kresident
from lgm_tpu_torch.ops.mha import (F32_ROUTE, ROUTES, f32_warpgroups,
                                   kernel_takes, launch_plan, mha, mha_bwd,
                                   mha_bwd_f32, mha_bwd_reference, mha_fwd,
                                   mha_fwd_f32, mha_reference,
                                   mha_split_tf32, route, warpgroups)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("S,D", [(256, 32), (256, 64), (512, 32), (512, 64)])
def test_mha_matches_kresident(S, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.normal(0, 1, (2, S, D)).astype(np.float32)
               for _ in range(3))
    scale = float(D) ** -0.5
    o_jax = np.asarray(mha_kresident(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale
    ).astype(jnp.float32))
    launches = mha_fwd.launches
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    o = mha_fwd(tq, tk, tv, scale)
    assert o.dtype == torch.bfloat16 and mha_fwd.launches == launches
    # Same bf16 inputs, same P rounding; only f32 summation order differs,
    # so the bf16 outputs agree to one bf16 rounding step (2^-8 relative).
    err = np.abs(o.float().numpy() - o_jax).max()
    assert err <= 2.0 ** -8 * np.abs(o_jax).max(), err
    # The statistic K1 stores for K1ᵇ: the logsumexp of the scaled logits
    # of the same bf16 inputs, against numpy in f64 (only the f32
    # summation order differs: 1e-5 relative).
    o2, lse = mha_fwd(tq, tk, tv, scale, return_lse=True)
    assert torch.equal(o2, o) and lse.dtype == torch.float32
    assert lse.shape == (2, S)
    logits = np.einsum("bqd,bkd->bqk", *(x.double().numpy()
                                          for x in (tq, tk))) * scale
    m = logits.max(axis=-1)
    want = m + np.log(np.exp(logits - m[..., None]).sum(axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5)


def test_mha_reference_f32_is_softmax_attention():
    """At f32 the plain version is exact softmax attention (no rounding)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, (3, 64, 16)),
                               dtype=torch.float32) for _ in range(3))
    ref = torch.softmax(q @ k.transpose(1, 2) * 0.25, dim=-1) @ v
    torch.testing.assert_close(mha_reference(q, k, v, 0.25), ref,
                               atol=1e-5, rtol=1e-5)


def test_mha_fwd_rejects_other_devices():
    q = torch.empty(1, 64, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        mha_fwd(q, q, q, 1.0)


@pytest.mark.parametrize("S,D", [(256, 32), (256, 64), (512, 32), (512, 64)])
def test_mha_bwd_matches_kresident_vjp(S, D):
    """K1ᵇ's plain version vs jax.vjp of mha_kresident (the TPU backward
    kernel in interpret mode), bf16, from the same q, k, v, o and cotangent
    dO, and the forward's row logsumexp (which the TPU kernel recomputes).
    Both round dO, dS and P to bf16 before their products and sum in f32
    in different orders, so a bf16 dS may round the other way: the bf16
    gradients agree to two rounding steps of their scale (2^-7 of the
    largest |value|)."""
    rng = np.random.default_rng(S * D)
    q, k, v, do = (rng.normal(0, 1, (2, S, D)).astype(np.float32)
                   for _ in range(4))
    scale = float(D) ** -0.5
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o_jax, vjp = jax.vjp(lambda a, b, c: mha_kresident(a, b, c, scale),
                         qj, kj, vj)
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(doj)]
    o = torch.as_tensor(np.asarray(o_jax.astype(jnp.float32))).to(
        torch.bfloat16)
    tq, tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v))
    # The statistic from the port's forward on the same inputs, as autograd
    # hands it to K1ᵇ (the TPU backward recomputes it instead).
    _, lse = mha_fwd(tq, tk, tv, scale, return_lse=True)
    ours = mha_bwd(tq, tk, tv, o, torch.as_tensor(do).to(torch.bfloat16),
                   scale, lse)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        assert a.dtype == torch.bfloat16
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 2.0 ** -7 * np.abs(b).max(), (name, err)


def test_mha_autograd_is_softmax_attention_gradient():
    """At f32 the autograd path (K1 forward, K1ᵇ backward on CPU tensors:
    their plain versions) gives autograd's own softmax-attention gradient,
    to f32 summation order (1e-5)."""
    rng = np.random.default_rng(2)
    q, k, v, g = (torch.as_tensor(rng.normal(0, 1, (3, 64, 16)),
                                  dtype=torch.float32) for _ in range(4))
    ours = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    out = mha(*ours, 0.25)
    # _MHA's residuals: q, k, v, o and the [BH, S] f32 row logsumexp.
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert saved[4].dtype == torch.float32 and saved[4].shape == (3, 64)
    (out * g).sum().backward()
    (torch.softmax(ref[0] @ ref[1].transpose(1, 2) * 0.25, dim=-1) @ ref[2]
     * g).sum().backward()
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)
    # Without a recorded graph, mha is the plain forward.
    with torch.no_grad():
        torch.testing.assert_close(mha(q, k, v, 0.25),
                                   mha_reference(q, k, v, 0.25))


def test_mha_bwd_rejects_other_devices():
    q = torch.empty(1, 64, 32, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError):
        mha_bwd(q, q, q, q, q, 1.0, lse)


@pytest.mark.parametrize("S,D,vp", [(256, 64, 4), (512, 32, 2),
                                    (512, 64, 4)])
def test_vp_rank_rows_match_kresident(S, D, vp):
    """Unequal lengths, as on a vp rank of the view-sharded U-Net: each
    rank's S/vp queries against all S keys (the plain versions of K1 and
    K1ᵇ, K1ᵇ with f32 dK/dV partials), against lgm_tpu's mha_kresident
    and its VJP on the whole sequence (interpret mode). The rank's o and
    dq are those rows of lgm_tpu's, and the sum of the ranks' f32 dK and
    dV, rounded once to bf16, is lgm_tpu's dk and dv: to one bf16
    rounding step (2^-8) of the scale for o, two (2^-7) for the
    gradients, as the equal-length tests. The rank's row logsumexp is
    those rows of the equal-length call's, to f32 summation order."""
    rng = np.random.default_rng(S * D + vp)
    q, k, v, do = (rng.normal(0, 1, (2, S, D)).astype(np.float32)
                   for _ in range(4))
    scale = float(D) ** -0.5
    qj, kj, vj, doj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o_jax, vjp = jax.vjp(lambda a, b, c: mha_kresident(a, b, c, scale),
                         qj, kj, vj)
    dq_j, dk_j, dv_j = (np.asarray(g.astype(jnp.float32)) for g in vjp(doj))
    o_jax = np.asarray(o_jax.astype(jnp.float32))
    tq, tk, tv, tdo = (torch.as_tensor(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    _, lse_full = mha_fwd(tq, tk, tv, scale, return_lse=True)
    n = S // vp
    assert kernel_takes(torch.bfloat16, n, S, D, scale)
    dk_sum = torch.zeros(2, S, D)
    dv_sum = torch.zeros(2, S, D)
    for r in range(vp):
        rows = slice(r * n, (r + 1) * n)
        o, lse = mha_fwd(tq[:, rows].contiguous(), tk, tv, scale,
                         return_lse=True)
        assert o.shape == (2, n, D) and lse.shape == (2, n)
        err = np.abs(o.float().numpy() - o_jax[:, rows]).max()
        assert err <= 2.0 ** -8 * np.abs(o_jax).max(), err
        np.testing.assert_allclose(lse.numpy(), lse_full[:, rows].numpy(),
                                   rtol=1e-5)
        dq, dk, dv = mha_bwd(tq[:, rows].contiguous(), tk, tv, o,
                             tdo[:, rows].contiguous(), scale, lse,
                             dkv_f32=True)
        assert dq.dtype == torch.bfloat16
        assert dk.dtype == dv.dtype == torch.float32
        assert dk.shape == dv.shape == (2, S, D)
        err = np.abs(dq.float().numpy() - dq_j[:, rows]).max()
        assert err <= 2.0 ** -7 * np.abs(dq_j).max(), ("dq", r, err)
        dk_sum += dk
        dv_sum += dv
    for name, ours, ref in (("dk", dk_sum, dk_j), ("dv", dv_sum, dv_j)):
        err = np.abs(ours.to(torch.bfloat16).float().numpy() - ref).max()
        assert err <= 2.0 ** -7 * np.abs(ref).max(), (name, err)


def test_kernel_takes_unequal_lengths():
    """K1 and K1ᵇ take Sq queries, a multiple of 64, against Sk keys, a
    multiple of 128: the big preset's 8² sites at vp 4 are Sq 64, Sk 256."""
    for Sq, Sk, want in ((64, 256, True), (128, 256, True), (192, 256, True),
                         (256, 256, True), (32, 256, False),
                         (64, 192, False), (0, 256, False)):
        assert kernel_takes(torch.bfloat16, Sq, Sk, 64, 0.125) == want
        assert kernel_takes(torch.float32, Sq, Sk, 64, 0.125) == want
    # f32 is taken (the exact f32 kernels); f16 and f64 are not.
    assert kernel_takes(torch.float32, 64, 256, 64, 0.125)
    assert not kernel_takes(torch.float16, 64, 256, 64, 0.125)
    assert not kernel_takes(torch.float64, 64, 256, 64, 0.125)


def test_mha_bwd_reference_f32_partials_are_the_unrounded_dkv():
    """``dkv_f32``: dK and dV unrounded, f32; their bf16 rounding is the
    default call's dK and dV, and dq is the same."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (2, s, 32)),
                                   dtype=torch.float32).to(torch.bfloat16)
                   for s in (64, 256, 256, 64))
    o, lse = mha_fwd(q, k, v, 32 ** -0.5, return_lse=True)
    dq, dk, dv = mha_bwd_reference(q, k, v, o, do, 32 ** -0.5, lse)
    dq32, dk32, dv32 = mha_bwd_reference(q, k, v, o, do, 32 ** -0.5, lse,
                                         dkv_f32=True)
    assert dk32.dtype == dv32.dtype == torch.float32
    assert torch.equal(dq32, dq)
    assert torch.equal(dk32.to(torch.bfloat16), dk)
    assert torch.equal(dv32.to(torch.bfloat16), dv)


# LGM big's three attention site shapes (S, D) and the diffusion U-Net's
# level-0 self-attention (MVDream, ImageDream).
SITE_SHAPES = [(4096, 32), (1024, 64), (256, 64), (4096, 64), (5120, 64)]
H100_SMS = 132


@pytest.mark.parametrize("S,D", SITE_SHAPES)
def test_route_depends_on_d_and_keys_only(S, D):
    """The route is a function of D alone, reading neither length: a vp
    rank's S/vp queries against S keys launch on the full call's route,
    whatever BH, so its rows are the full call's arithmetic. Both head
    dims take the wgmma route, at every site length."""
    want = route(D)
    assert want == "wgmma" and ROUTES == (want,)
    for vp in (1, 2, 4):
        for BH in (10, 16, 20, 32):
            assert launch_plan(BH, S // vp, S, D, H100_SMS)["route"] == want


@pytest.mark.parametrize("S,D", SITE_SHAPES)
def test_launch_plan_is_the_warpgroups_at_each_head_dim(S, D):
    """At D 32 as at D 64 each kernel's block is a number of consumer
    warpgroups: ``warpgroups`` at that head dim over the rows it runs over
    (queries in K1 and the dq kernel, keys in the dK/dV kernel), for the
    full call and a vp rank's S/vp queries."""
    for vp in (1, 2, 4):
        for BH in (10, 16, 20, 32):
            plan = launch_plan(BH, S // vp, S, D, H100_SMS)
            assert plan == dict(
                route="wgmma", fwd=warpgroups(BH, S // vp, H100_SMS, D),
                dq=warpgroups(BH, S // vp, H100_SMS, D),
                dkv=warpgroups(BH, S, H100_SMS, D))
    # LGM big's S 4096 sites take four warpgroups at B = 1 and bs2.
    if (S, D) == (4096, 32):
        for BH in (16, 32):
            assert launch_plan(BH, S, S, D, H100_SMS) == dict(
                route="wgmma", fwd=4, dq=4, dkv=4)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("rows", [64, 128, 192, 256, 1024, 1280, 4096, 5120])
@pytest.mark.parametrize("BH", [1, 3, 10, 16, 20, 32])
def test_warpgroups_tile_the_rows(BH, rows, D):
    """The wgmma kernels' block is 1, 2 or (at D 32) 4 consumer warpgroups
    of 64 rows: whole blocks over any multiple of 64 rows; 4 only where the
    256-row blocks fill every SM at least once, else 2 only where the
    64-row units outnumber the SMs (one block an SM)."""
    nc = warpgroups(BH, rows, H100_SMS, D)
    assert nc in ((1, 2, 4) if D == 32 else (1, 2)) and rows % (64 * nc) == 0
    four = D == 32 and rows % 256 == 0 and rows // 256 * BH >= H100_SMS
    assert (nc == 4) == four
    assert (nc == 2) == (not four and rows % 128 == 0
                         and rows // 64 * BH > H100_SMS)


@pytest.mark.parametrize("D", [32, 64])
def test_cpu_tensors_take_the_plain_versions(D):
    """On CPU tensors ``mha_fwd`` and ``mha_bwd`` are the plain versions,
    whatever the route at that shape, and count no launch."""
    rng = np.random.default_rng(D)
    q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (2, s, D)),
                                   dtype=torch.float32).to(torch.bfloat16)
                   for s in (128, 1024, 1024, 128))
    counts = (mha_fwd.launches, mha_bwd.launches,
              dict(mha_fwd.route_launches), dict(mha_bwd.route_launches))
    o, lse = mha_fwd(q, k, v, D ** -0.5, return_lse=True)
    ref, ref_lse = mha_reference(q, k, v, D ** -0.5, return_lse=True)
    assert torch.equal(o, ref) and torch.equal(lse, ref_lse)
    for a, b in zip(mha_bwd(q, k, v, o, do, D ** -0.5, lse),
                    mha_bwd_reference(q, k, v, o, do, D ** -0.5, lse)):
        assert torch.equal(a, b)
    assert counts == (mha_fwd.launches, mha_bwd.launches,
                      mha_fwd.route_launches, mha_bwd.route_launches)
    assert counts[0] == counts[1] == 0
    assert set(counts[2].values()) == set(counts[3].values()) == {0}


def _exact_attention_f64(q, k, v, do, scale):
    """Softmax attention and its backward in f64 numpy: o, dq, dk, dv."""
    q, k, v, do = (np.asarray(x, np.float64) for x in (q, k, v, do))
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    o = p @ v
    dp = do @ v.transpose(0, 2, 1)
    ds = p * (dp - (do * o).sum(axis=-1, keepdims=True))
    return (o, ds @ k * scale, ds.transpose(0, 2, 1) @ q * scale,
            p.transpose(0, 2, 1) @ do)


def _row_err(ours, ref):
    """The worst row's max error over that row's largest |value|."""
    return float((np.abs(ours - ref).max(axis=-1)
                  / np.abs(ref).max(axis=-1)).max())


@pytest.mark.parametrize("BH,Sq,Sk,D", [(2, 256, 256, 32), (4, 128, 512, 64),
                                        (2, 512, 512, 64)])
def test_f32_plain_versions_are_exact_attention(BH, Sq, Sk, D):
    """At f32 the plain versions of K1 and K1ᵇ (what the f32 kernels are
    held to on the card) are exact softmax attention and its backward: o,
    dq, dk and dv within 1e-5 of each row's largest |value| of f64 numpy
    (f32 products and sums in other orders), at equal lengths and at a vp
    rank's Sq < Sk; the statistic is the f64 row logsumexp to 1e-5."""
    rng = np.random.default_rng(BH * Sq + Sk + D)
    q, do = (rng.normal(0, 1, (BH, Sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(0, 1, (BH, Sk, D)).astype(np.float32)
            for _ in range(2))
    scale = float(D) ** -0.5
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    assert kernel_takes(torch.float32, Sq, Sk, D, scale)
    o, lse = mha_reference(tq, tk, tv, scale, return_lse=True)
    grads = mha_bwd_reference(tq, tk, tv, o, tdo, scale, lse)
    want = _exact_attention_f64(q, k, v, do, scale)
    for name, ours, ref in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert ours.dtype == torch.float32
        assert _row_err(ours.numpy(), ref) <= 1e-5, name
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    m = s.max(axis=-1)
    np.testing.assert_allclose(
        lse.numpy(), m + np.log(np.exp(s - m[..., None]).sum(axis=-1)),
        rtol=1e-5)
    # f32 throughout: dK and dV are the same f32 values with dkv_f32.
    for a, b in zip(grads, mha_bwd_reference(tq, tk, tv, o, tdo, scale, lse,
                                             dkv_f32=True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,D", [(256, 32), (512, 64)])
def test_f32_plain_versions_match_kresident(S, D):
    """The f32 plain versions against lgm_tpu's mha_kresident and its VJP
    on the same f32 inputs (interpret mode), which return f32. lgm_tpu's
    kernel body rounds P to bf16 before P.V, and dO, dS and P before their
    products, at any input dtype (lgm_tpu/ops/mha.py:54,91,97,108); the
    port keeps them in f32 (README). So the tolerance is set by those
    roundings, not by f32: o within 2^-8 of its largest |value| (one bf16
    step of P; 1.3e-3 measured at these shapes), dq, dk and dv within 2^-6
    (dO, dS and P each rounded, dS after the cancellation dP - D; up to
    5.7e-3 measured)."""
    rng = np.random.default_rng(S + D)
    q, k, v, do = (rng.normal(0, 1, (2, S, D)).astype(np.float32)
                   for _ in range(4))
    scale = float(D) ** -0.5
    o_jax, vjp = jax.vjp(lambda a, b, c: mha_kresident(a, b, c, scale),
                         *(jnp.asarray(x) for x in (q, k, v)))
    assert o_jax.dtype == jnp.float32
    ref = [np.asarray(o_jax)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o, lse = mha_fwd(tq, tk, tv, scale, return_lse=True)
    grads = mha_bwd(tq, tk, tv, o, tdo, scale, lse)
    for name, ours, want, tol in zip(("o", "dq", "dk", "dv"), (o, *grads),
                                     ref, (2.0 ** -8,) + (2.0 ** -6,) * 3):
        assert ours.dtype == torch.float32
        err = np.abs(ours.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), (name, err)


def test_f32_launch_plan_is_the_warps():
    """f32 inputs take the one design of the f32 kernels (3xTF32 on
    wgmma), blocks of 64-row consumer warpgroups: K1 as the bf16 K1 (4 at
    D = 32 where 256-row blocks fill every SM, else 2 where 128-row blocks
    outnumber the SMs, else 1), the dq and dK/dV kernels at most 2 at D =
    32 and 1 at D = 64; each a whole number of blocks over the queries
    (fwd, dq) and the keys (dkv)."""
    for BH, S, D, vp in ((16, 4096, 32, 1), (32, 4096, 32, 2),
                         (16, 256, 64, 1), (32, 1024, 64, 4),
                         (128, 4096, 32, 1), (16, 256, 64, 4),
                         (16, 1024, 64, 1), (16, 4096, 32, 4)):
        plan = launch_plan(BH, S // vp, S, D, H100_SMS, torch.float32)
        assert plan["route"] == F32_ROUTE
        assert plan == dict(route=F32_ROUTE, **f32_warpgroups(
            BH, S // vp, S, D, H100_SMS))
        fwd = warpgroups(BH, S // vp, H100_SMS, D)
        assert plan["fwd"] == fwd
        assert plan["dq"] == (1 if D == 64 else min(2, fwd))
        assert plan["dkv"] == (1 if D == 64 else
                               min(2, warpgroups(BH, S, H100_SMS, D)))
        for key, rows in (("fwd", S // vp), ("dq", S // vp), ("dkv", S)):
            assert rows % (64 * plan[key]) == 0
    # LGM big's S 4096 sites: four consumers in K1, two in K1ᵇ's kernels.
    assert launch_plan(32, 4096, 4096, 32, H100_SMS, torch.float32) == dict(
        route=F32_ROUTE, fwd=4, dq=2, dkv=2)


def test_f32_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    """On CPU tensors the f32 wrappers are the plain versions and count no
    launch; mha carries f32 through its autograd Function unchanged."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (2, s, 32)),
                                   dtype=torch.float32)
                   for s in (64, 128, 128, 64))
    counts = (mha_fwd_f32.launches, mha_bwd_f32.launches, mha_fwd.launches,
              mha_bwd.launches, mha_split_tf32.launches)
    o, lse = mha_fwd_f32(q, k, v, 0.2, return_lse=True)
    ref, ref_lse = mha_reference(q, k, v, 0.2, return_lse=True)
    assert torch.equal(o, ref) and torch.equal(lse, ref_lse)
    for a, b in zip(mha_bwd_f32(q, k, v, o, do, 0.2, lse),
                    mha_bwd_reference(q, k, v, o, do, 0.2, lse)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = mha(qs, ks, vs, 0.2)
    out.backward(do)
    assert out.dtype == torch.float32 and torch.equal(out.detach(), ref)
    assert all(x.grad.dtype == torch.float32 for x in (qs, ks, vs))
    assert counts == (mha_fwd_f32.launches, mha_bwd_f32.launches,
                      mha_fwd.launches, mha_bwd.launches,
                      mha_split_tf32.launches) == (0, 0, 0, 0, 0)
