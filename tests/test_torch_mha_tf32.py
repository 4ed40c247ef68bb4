"""The f32 kernels' algorithm on the CPU, where no kernel runs: the split
pass's plain version (TF32 halves, the transposed planes with their
permuted 8-row groups) and an emulation in torch of K1's and K1ᵇ's 3xTF32
arithmetic from those planes, held against the exact f32 plain versions
and against lgm_tpu's mha_kresident and its VJP (interpret mode)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lgm_tpu.ops.mha import mha_kresident
from lgm_tpu_torch.ops.mha import (TF32_PERM, _perm_rows, mha_bwd_reference,
                                   mha_reference, mha_split_tf32,
                                   split_tf32_reference, tf32_rna)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# chip_smoke.py's K1_F32_REL_TOL: the f32 kernels against the plain
# versions, 1e-5 of the largest |value| (3xTF32 products are ~2^-22 of |a
# b| from f32 products, and the sums run in other orders).
K1_F32_REL_TOL = 1e-5
STEP = 32  # rows (keys or queries) a step of the kernels' products
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def test_rna_rounds_to_nearest_ties_away():
    """rna keeps 10 explicit mantissa bits: the low 13 bits cleared, the
    magnitude rounded to nearest, a tie away from zero, the sign kept."""
    ulp = 2.0 ** -10  # TF32's step in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      1.0 + 3 * ulp / 2, -(1.0 + ulp / 2), 3.0, 0.0,
                      -2.0 ** -30], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp, -(1.0 + ulp),
                         3.0, 0.0, -2.0 ** -30], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    r = tf32_rna(torch.as_tensor(_inputs(0, [(4096,)])[0]))
    assert not (r.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("R,D", [(64, 32), (96, 64), (256, 32)])
def test_split_halves_sum_to_x(R, D):
    """hi + lo = x to 2^-22 of |x|, both halves TF32 (low 13 bits 0), and
    hi is x to 2^-11."""
    x = torch.as_tensor(_inputs(R + D, [(2, R, D)])[0] * 10.0)
    planes = split_tf32_reference(x, rows=True, cols=True)
    hi, lo = planes["hi"], planes["lo"]
    for h in (hi, lo, planes["hi_t"], planes["lo_t"]):
        assert h.dtype == torch.float32
        assert not (h.contiguous().view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    assert ((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((hi.double() + lo.double() - xd).abs()
            <= 2.0 ** -22 * xd.abs()).all()


@pytest.mark.parametrize("R,D", [(64, 32), (128, 64)])
def test_transposed_planes_restore_the_operands(R, D):
    """The transposed planes [BH, D, R] are the row-major halves with the
    rows of each 8-row group in TF32_PERM's order: putting each row back
    where TF32_PERM says restores V, K, Q and dO's halves exactly, and the
    group order is the one a column pair (2 t, 2 t + 1) of the
    accumulators takes as the A operand's k indices (t, t + 4)."""
    assert TF32_PERM == tuple(2 * p if p < 4 else 2 * (p - 4) + 1
                              for p in range(8))
    # The m64nNk8 accumulator gives lane t of a quad the columns 2 t and
    # 2 t + 1 of an 8-column group; the tf32 A fragment takes its k
    # indices t and t + 4 from them: k index p holds column TF32_PERM[p].
    cols = [None] * 8
    for t in range(4):
        cols[t], cols[t + 4] = 2 * t, 2 * t + 1
    assert tuple(cols) == TF32_PERM
    for x in (torch.as_tensor(a) for a in _inputs(R * D, [(3, R, D)] * 4)):
        planes = split_tf32_reference(x, rows=True, cols=True)
        idx = _perm_rows(R, x.device)
        for half in ("hi", "lo"):
            t = planes[f"{half}_t"]
            assert t.shape == (3, D, R) and t.is_contiguous()
            back = torch.empty_like(x)
            back[:, idx] = t.transpose(1, 2)
            assert torch.equal(back, planes[half])
        # Rows only, or the transposed planes only, as asked.
        assert set(split_tf32_reference(x, True, False)) == {"hi", "lo"}
        assert set(split_tf32_reference(x, False, True)) == {"hi_t", "lo_t"}


def test_split_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors the split pass is its plain version, operand by
    operand, and counts no launch."""
    q, v = (torch.as_tensor(a) for a in _inputs(3, [(2, 64, 32)] * 2))
    before = mha_split_tf32.launches
    got = mha_split_tf32(((q, True, True), (v, False, True)))
    want = [split_tf32_reference(q, True, True),
            split_tf32_reference(v, False, True)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(torch.equal(g[key], w[key]) for key in g)
    assert mha_split_tf32.launches == before


def _three(ah, al, bh, bl):
    """A.B by 3xTF32 from the halves: lo.hi + hi.lo, then + hi.hi (the
    small terms first); each product of TF32 values exact in f32."""
    return (al @ bh + ah @ bl) + ah @ bh


def _a_halves(x):
    """The register A operand of a product over a step's 32 columns: the
    columns of each 8-column group in TF32_PERM's order, split."""
    xp = x[..., _perm_rows(x.shape[-1], x.device)]
    hi = tf32_rna(xp)
    return hi, tf32_rna(xp - hi)


def emulate_fwd(q, k, v, scale):
    """K1 at f32 as the kernel computes it from the split pass's planes:
    the row max of one TF32 pass, then per 32-key step S by three
    products, P = 2^(s c - m2), P.V by three products with P split into
    the A operand (permuted) and V's transposed planes, the step's sum
    added to the row in f32; o = acc / l, L = (m2 + log2 l) ln 2."""
    pq, pk, pv = (split_tf32_reference(x, r, c)
                  for x, r, c in ((q, True, False), (k, True, False),
                                  (v, False, True)))
    cc = scale * LOG2E
    qh, ql = pq["hi"], pq["lo"]
    m2 = (qh @ pk["hi"].transpose(1, 2)).amax(-1, keepdim=True) * cc
    acc = torch.zeros_like(q)
    l = torch.zeros_like(m2)
    for j in range(0, k.shape[1], STEP):
        kh, kl = (pk[h][:, j:j + STEP].transpose(1, 2) for h in ("hi", "lo"))
        p = torch.exp2(_three(qh, ql, kh, kl) * cc - m2)
        l = l + p.sum(-1, keepdim=True)
        vh, vl = (pv[h][:, :, j:j + STEP].transpose(1, 2)
                  for h in ("hi_t", "lo_t"))
        acc = acc + _three(*_a_halves(p), vh, vl)
    return acc / l, ((m2 + torch.log2(l)) * LN2).squeeze(-1)


def emulate_bwd(q, k, v, o, do, scale, lse):
    """K1ᵇ at f32 as its two kernels compute it from the planes: (a) per
    32-key step S and dP by three products, P = 2^(s c - L2), dS = P (dP -
    D), dq += dS.K with dS split (permuted) against K's transposed planes;
    (b) per 32-query step S^T and dP^T, dV += P^T.dO and dK += dS^T.Q
    against dO's and Q's transposed planes; each step's sum added in f32."""
    pq, pk, pv, pd = (split_tf32_reference(x, r, c)
                      for x, r, c in ((q, True, True), (k, True, True),
                                      (v, True, False), (do, True, True)))
    cc = scale * LOG2E
    l2 = lse * LOG2E
    drow = (do * o).sum(-1)
    T = lambda x: x.transpose(1, 2)  # noqa: E731
    dq = torch.zeros_like(q)
    for j in range(0, k.shape[1], STEP):
        s = _three(pq["hi"], pq["lo"], T(pk["hi"][:, j:j + STEP]),
                   T(pk["lo"][:, j:j + STEP]))
        dp = _three(pd["hi"], pd["lo"], T(pv["hi"][:, j:j + STEP]),
                    T(pv["lo"][:, j:j + STEP]))
        p = torch.exp2(s * cc - l2[..., None])
        ds = p * (dp - drow[..., None])
        dq = dq + _three(*_a_halves(ds), T(pk["hi_t"][:, :, j:j + STEP]),
                         T(pk["lo_t"][:, :, j:j + STEP]))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(0, q.shape[1], STEP):
        st = _three(pk["hi"], pk["lo"], T(pq["hi"][:, i:i + STEP]),
                    T(pq["lo"][:, i:i + STEP]))
        dpt = _three(pv["hi"], pv["lo"], T(pd["hi"][:, i:i + STEP]),
                     T(pd["lo"][:, i:i + STEP]))
        p = torch.exp2(st * cc - l2[:, None, i:i + STEP])
        dst = p * (dpt - drow[:, None, i:i + STEP])
        dv = dv + _three(*_a_halves(p), T(pd["hi_t"][:, :, i:i + STEP]),
                         T(pd["lo_t"][:, :, i:i + STEP]))
        dk = dk + _three(*_a_halves(dst), T(pq["hi_t"][:, :, i:i + STEP]),
                         T(pq["lo_t"][:, :, i:i + STEP]))
    return dq * scale, dk * scale, dv


def _rel(ours, ref):
    return float((ours - ref).abs().max()) / float(ref.abs().max())


CASES = [(2, 64, 64, 32), (2, 128, 128, 64), (2, 256, 256, 32),
         (2, 256, 256, 64), (2, 64, 256, 32), (2, 128, 256, 64)]


@pytest.mark.parametrize("BH,Sq,Sk,D", CASES)
def test_emulation_is_exact_attention(BH, Sq, Sk, D):
    """The kernels' 3xTF32 arithmetic against the exact f32 plain versions
    (f32 products, TF32 off), at equal lengths and a vp rank's Sq < Sk: o,
    dq, dk and dv within K1_F32_REL_TOL of the largest |value|, the
    statistic within 1e-5 of max(1, |L|), as the card holds the kernels."""
    q, do = (torch.as_tensor(a) for a in _inputs(BH * Sq + D,
                                                 [(BH, Sq, D)] * 2))
    k, v = (torch.as_tensor(a) for a in _inputs(Sk + D, [(BH, Sk, D)] * 2))
    scale = D ** -0.5
    ref, ref_lse = mha_reference(q, k, v, scale, return_lse=True)
    o, lse = emulate_fwd(q, k, v, scale)
    assert _rel(o, ref) <= K1_F32_REL_TOL
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * max(
        1.0, float(ref_lse.abs().max()))
    grads = emulate_bwd(q, k, v, ref, do, scale, ref_lse)
    want = mha_bwd_reference(q, k, v, ref, do, scale, ref_lse)
    for name, ours, w in zip(("dq", "dk", "dv"), grads, want):
        assert _rel(ours, w) <= K1_F32_REL_TOL, (name, _rel(ours, w))


def test_emulation_needs_the_permutation():
    """Read the transposed planes in plain row order (no permutation of P)
    and P.V comes out wrong far past the tolerance: the case above holds
    the permutation, not only the halves."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(11, [(2, 64, 32)] * 3))
    ref = mha_reference(q, k, v, 0.2)
    o, _ = emulate_fwd(q, k, v, 0.2)
    assert _rel(o, ref) <= K1_F32_REL_TOL
    p = torch.softmax(q @ k.transpose(1, 2) * 0.2, -1)
    vt = split_tf32_reference(v, False, True)["hi_t"].transpose(1, 2)
    assert _rel(p @ vt, ref) > 1e-2


@pytest.mark.parametrize("S,D", [(128, 32), (256, 64)])
def test_emulation_matches_kresident(S, D):
    """The emulation against lgm_tpu's mha_kresident and its VJP on the
    same f32 inputs (interpret mode), at the tolerances of
    test_f32_plain_versions_match_kresident: lgm_tpu's kernel body rounds
    P to bf16 before P.V, and dO, dS and P before their products
    (lgm_tpu/ops/mha.py:54,91,97,108), where the port keeps f32: o within
    2^-8 of its largest |value|, dq, dk and dv within 2^-6."""
    q, k, v, do = _inputs(S * D, [(2, S, D)] * 4)
    scale = float(D) ** -0.5
    o_jax, vjp = jax.vjp(lambda a, b, c: mha_kresident(a, b, c, scale),
                         *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(o_jax)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o, lse = emulate_fwd(tq, tk, tv, scale)
    grads = emulate_bwd(tq, tk, tv, o, tdo, scale, lse)
    for name, ours, w, tol in zip(("o", "dq", "dk", "dv"), (o, *grads), want,
                                  (2.0 ** -8,) + (2.0 ** -6,) * 3):
        err = np.abs(ours.numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (name, err)
    assert math.isfinite(float(lse.abs().max()))
