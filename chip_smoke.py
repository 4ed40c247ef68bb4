#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's kernels from the sources in the checkout, holds each
against its plain PyTorch version at the shapes its path gives it, times
both, and drives the port's two paths, each with the launch counts set to
0 just before it and read just after:

- inference: LGM ``big`` at full width with seeded weights, forward ->
  .ply -> 180-frame orbit at 512² (kernels K1, K2);
- training: ``lgm_tpu_torch.train`` at ``big``, batch 2, seeded weights
  and synthetic batches, one cold and five warm steps through the
  trainer's own step function (K1, K1ᵇ, K2, K2ᵇ), then K1ᵇ and K2ᵇ held
  against their plain versions on that step's own inputs, then four
  steps with the U-Net recompute that ``train big`` runs by default.

Each phase prints one JSON line; any failure raises and the script exits
non-zero. The last three lines are the ``kernels`` summary, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result. Outputs of the inference path go to ``build/smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): bf16
# tensor-core rate, f32 rate outside the tensor cores, HBM bandwidth. The
# exp rate is that of the SFUs: 16 per clock per SM, 132 SMs, 1.98 GHz
# maximum boost clock.
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9

# K1 at the big preset, B = 1, 16 heads: (BH, S, D) and the number of
# MVAttention sites of that shape in one forward (down3 x2 + up2 x3 at
# 32², down4 x2 + up1 x3 at 16², down5 x2 + mid x1 + up0 x3 at 8²).
K1_SHAPES = [((16, 4096, 32), 5), ((16, 1024, 64), 5), ((16, 256, 64), 6)]
# K1ᵇ in the big bs2 train step: (BH, S, D) with BH = 2 * 16 heads, and
# the sites of that shape (as K1_SHAPES).
K1B_SHAPES = [((32, 4096, 32), 5), ((32, 1024, 64), 5), ((32, 256, 64), 6)]
# K1 and K1ᵇ tolerance: bf16 outputs, whose rounding step is 2^-8 of the
# value; kernel and plain version sum in different orders (and K1ᵇ's bf16
# dS and P may round the other way), so allow two steps of the scale.
K1_REL_TOL = 2.0 ** -7
# K2 tolerance: f32 sums in another order (and FMA contraction), plus the
# tile early-out at T <= 1e-4, which may flip at the threshold: at most
# 1e-4 of a value <= 2.5 (the depth row).
K2_ATOL = 1e-3
# f32 operations per (pixel, slot) pair of K2 up to the alpha test
# (dx, dy, the quadratic, op * e), and per pair that accumulates (alpha,
# w, three colour and one depth FMA, the alpha sum, T update).
K2_OPS_TEST, K2_OPS_ACCUM = 14, 16
# K2ᵇ per visited pair: the same alpha test; per pair that passes, the
# replay (s, w, prefix, dalpha, dpower: ~24), the R = 9 gradient terms
# (~17) and their sums over the tile's pixels (one add each, 10).
K2B_OPS_ACCUM = 51
# K2ᵇ tolerance, per gradient row: f32 sums over the tile's pixels in
# other orders, and the suffix taken as U_eff - prefix: 1e-4 of the row's
# largest |value|.
K2B_REL_TOL = 1e-4


# record_function ranges of the train step: forward (lgm, render, lpips
# inside it), backward, optimizer.
SCOPES = ("loss_forward", "lgm", "render", "lpips", "loss_backward",
          "optimizer")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(ops_s: dict, bytes_moved: float):
    """Least time (ms) for the work: the larger of each resource's time."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S, **ops_s}
    worst = max(times, key=times.get)
    return times[worst] * 1e3, "bytes" if worst == "bytes" else "operations"


def k2_bound(work: dict, R: int, counts, S: int):
    """K2's bound from the work these inputs need: one exp and the f32
    operations per visited (pixel, slot) pair; the staged slot rows, the
    counts and the [T, 8, P] output once each."""
    return bound(
        {"exp": work["pairs"] / SFU_EXP_PER_S,
         "f32": (K2_OPS_TEST * work["pairs"] + K2_OPS_ACCUM * work["used"])
         / F32_FLOPS},
        work["slots"] * R * 4 + counts.numel() * 4 + 8 * S * S * 4)


def k2b_bound(work: dict, R: int, counts, S: int, mpt: int):
    """K2ᵇ's bound: one exp and the f32 operations per visited pair; the
    staged slot rows, the counts, fo and go once each, and the gradient
    rows written."""
    T = counts.numel()
    return bound(
        {"exp": work["pairs"] / SFU_EXP_PER_S,
         "f32": (K2_OPS_TEST * work["pairs"] + K2B_OPS_ACCUM * work["used"])
         / F32_FLOPS},
        work["slots"] * R * 4 + T * 4 + 2 * 8 * S * S * 4 + T * mpt * R * 4)


def k1b_bound(BH: int, S: int, D: int):
    """K1ᵇ's bound: 10 BH S² D tensor-core flops (Q.Kᵀ, dO.Vᵀ, dS.K,
    dSᵀ.Q, Pᵀ.dO), BH S² exps and ~5 f32 operations per logit; q, k, v,
    o, dO read and dq, dk, dv written once."""
    return bound(
        {"tensor": 10.0 * BH * S * S * D / BF16_TENSOR_FLOPS,
         "exp": BH * S * S / SFU_EXP_PER_S,
         "f32": 5.0 * BH * S * S / F32_FLOPS},
        8 * BH * S * D * 2)


def row_errors(ours, ref):
    """Max abs error over all rows, and the worst error of a row over its
    largest |value| (the K2ᵇ tolerance is per row)."""
    err = float((ours - ref).abs().max())
    rel = max(float((ours[..., r] - ref[..., r]).abs().max())
              / max(float(ref[..., r].abs().max()), 1e-30)
              for r in range(ref.shape[-1]))
    return err, rel


def check_k1b(q, k, v, o, do, scale, what):
    """K1ᵇ vs its plain version; returns the max abs error over dq, dk,
    dv and the tolerance it was held to."""
    import torch

    from lgm_tpu_torch.ops.mha import mha_bwd, mha_bwd_reference

    ours = mha_bwd(q, k, v, o, do, scale)
    ref = mha_bwd_reference(q, k, v, o, do, scale)
    torch.cuda.synchronize()
    worst, tol_worst = 0.0, 0.0
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        err = float((a.float() - b.float()).abs().max())
        tol = K1_REL_TOL * float(b.float().abs().max())
        if not err <= tol:
            raise AssertionError(f"K1ᵇ {what} {name}: max abs err {err} > "
                                 f"{tol}")
        if err >= worst:
            worst, tol_worst = err, tol
    return worst, tol_worst


def check_k2b(params, counts, fo, go, th, tw, tiles_x, what):
    import torch

    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    ours = fs.composite_bwd(params, counts, fo, go, th, tw, tiles_x)
    ref = fs.composite_bwd_reference(params, counts, fo, go, th, tw, tiles_x)
    torch.cuda.synchronize()
    err, rel = row_errors(ours, ref)
    if not rel <= K2B_REL_TOL:
        raise AssertionError(f"K2ᵇ {what}: a row's max error is {rel} of "
                             f"its scale > {K2B_REL_TOL}")
    return err, rel


def phase_build():
    from lgm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, so in libs.items():
        log = so.with_name(so.name + ".log").read_text().splitlines()
        ptxas[name] = [ln.strip() for ln in log if "registers" in ln]
    emit("build", seconds=seconds, kernels=sorted(libs), ptxas=ptxas)


def phase_k1(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import mha_fwd, mha_reference

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst_err, bound_by = 0.0, "operations"
    for (BH, S, D), sites in K1_SHAPES:
        rng = np.random.default_rng(S + D)
        q, k, v = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                   dtype=torch.float32, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale = float(D) ** -0.5
        with torch.inference_mode():
            o = mha_fwd(q, k, v, scale)
            ref = mha_reference(q, k, v, scale)
            torch.cuda.synchronize()
            err = float((o.float() - ref.float()).abs().max())
            tol = K1_REL_TOL * float(ref.float().abs().max())
            if not err <= tol:
                raise AssertionError(f"K1 {BH}x{S}x{D}: max abs err {err} "
                                     f"> {tol}")
            ms = cuda_ms(lambda: mha_fwd(q, k, v, scale))
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, scale))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale))
        b_ms, b_by = bound(
            {"tensor": 4.0 * BH * S * S * D / BF16_TENSOR_FLOPS,
             "exp": BH * S * S / SFU_EXP_PER_S,
             "f32": 5.0 * BH * S * S / F32_FLOPS},
            4 * BH * S * D * 2)
        emit("k1", shape=[BH, S, D], sites=sites, max_abs_err=err, tol=tol,
             kernel_ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
             bound_us=b_ms * 1e3, bound_by=b_by)
        worst_err = max(worst_err, err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", sdpa_ms), ("bound_ms", b_ms)):
            total[key] += sites * val
        if S == 4096:
            bound_by = b_by
    return dict(max_abs_err=worst_err, bound_by=bound_by, **total)


def phase_k2(dev):
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.infer import orbit_video_cameras
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    opt = CONFIGS["big"]
    S, th, tw, dup, mpt = opt.output_size, 32, 32, 32, 1024
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g = torch.as_tensor(sample_scene(np.random.default_rng(0), 65536),
                        device=dev)
    view = torch.as_tensor(orbit_video_cameras(opt, 180)["cam_view"][0],
                           device=dev)
    with torch.inference_mode():
        params, counts = fs._prepare_view(g, view, S, tan, 1.0, th, tw, dup,
                                          mpt, True)
        args = (params, counts, th, tw, S // tw)
        out = fs.composite_fwd(*args)
        ref = fs.composite_reference(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= K2_ATOL:
            raise AssertionError(f"K2: max abs err {err} > {K2_ATOL}")
        ms = cuda_ms(lambda: fs.composite_fwd(*args))
        plain_ms = cuda_ms(lambda: fs.composite_reference(*args), reps=5)
        work = fs.composite_work(*args)
    b_ms, b_by = k2_bound(work, params.shape[2], counts, S)
    emit("k2", tiles=int(params.shape[0]), splats=65536, image=S, dup=dup,
         slots_total=int(counts.sum()), live_pairs=work["pairs"],
         used_pairs=work["used"], max_abs_err=err, tol=K2_ATOL,
         kernel_ms=ms, plain_ms=plain_ms, bound_us=b_ms * 1e3,
         bound_by=b_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_k1_bwd(dev):
    """K1ᵇ at the three (BH, S, D) of the big bs2 train step, against its
    plain version and beside the backward of SDPA (through autograd)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import mha_bwd, mha_bwd_reference, \
        mha_reference

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst_err, bound_by = 0.0, "operations"
    for (BH, S, D), sites in K1B_SHAPES:
        rng = np.random.default_rng(7 * S + D)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(D) ** -0.5
        with torch.no_grad():
            o = mha_reference(q, k, v, scale)
            err, tol = check_k1b(q, k, v, o, do, scale, f"{BH}x{S}x{D}")
            ms = cuda_ms(lambda: mha_bwd(q, k, v, o, do, scale))
            plain_ms = cuda_ms(lambda: mha_bwd_reference(q, k, v, o, do,
                                                         scale), reps=5)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do[None], retain_graph=True))
        del out, qs, ks, vs
        b_ms, b_by = k1b_bound(BH, S, D)
        emit("k1_bwd", shape=[BH, S, D], sites=sites, max_abs_err=err,
             tol=tol, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_us=b_ms * 1e3, bound_by=b_by)
        worst_err = max(worst_err, err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms)):
            total[key] += sites * val
        if S == 4096:
            bound_by = b_by
    return dict(max_abs_err=worst_err, bound_by=bound_by, **total)


def phase_k2_bwd(dev):
    """K2ᵇ on the bench scene (view 0, 512², 65,536 splats, R = 9 as in
    training) with a seeded cotangent, against its plain version."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.infer import orbit_video_cameras
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    opt = CONFIGS["big"]
    S, th, tw, dup, mpt = opt.output_size, 32, 32, 32, 1024
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g = torch.as_tensor(sample_scene(np.random.default_rng(0), 65536),
                        device=dev)
    view = torch.as_tensor(orbit_video_cameras(opt, 180)["cam_view"][0],
                           device=dev)
    with torch.no_grad():
        params, counts = fs._prepare_view(g, view, S, tan, 1.0, th, tw, dup,
                                          mpt, False)
        args = (th, tw, S // tw)
        fo = fs.composite_fwd(params, counts, *args)
        go = torch.as_tensor(np.random.default_rng(1).normal(
            0, 1, tuple(fo.shape)), dtype=torch.float32, device=dev)
        err, rel = check_k2b(params, counts, fo, go, *args, "bench")
        ms = cuda_ms(lambda: fs.composite_bwd(params, counts, fo, go, *args))
        plain_ms = cuda_ms(lambda: fs.composite_bwd_reference(
            params, counts, fo, go, *args), reps=3, warm=1)
        work = fs.composite_work(params, counts, *args)
    b_ms, b_by = k2b_bound(work, params.shape[2], counts, S, mpt)
    emit("k2_bwd", tiles=int(params.shape[0]), splats=65536, image=S,
         dup=dup, R=int(params.shape[2]), slots_total=int(counts.sum()),
         live_pairs=work["pairs"], used_pairs=work["used"],
         max_abs_err=err, max_row_rel_err=rel, tol_row_rel=K2B_REL_TOL,
         kernel_ms=ms, plain_ms=plain_ms, bound_us=b_ms * 1e3,
         bound_by=b_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_main(dev):
    """LGM big inference through ``infer.process`` with seeded weights on
    four 256² views rendered by the port from a seeded scene."""
    from unittest import mock

    import numpy as np
    import torch

    import lgm_tpu_torch.models.unet as unet_mod
    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.gsplat.api import render_views
    from lgm_tpu_torch.ops.mha import mha_fwd, mha_reference
    from lgm_tpu_torch.utils import camera

    opt = CONFIGS["big"]
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    _, poses = camera.default_plucker_embedding(opt)
    cam_view = camera.build_camera_inputs(poses, opt.fovy, opt.znear,
                                          opt.zfar)["cam_view"]
    g = torch.as_tensor(sample_scene(np.random.default_rng(1), 65536),
                        device=dev)
    with torch.inference_mode():
        mv = render_views(g[None], torch.as_tensor(cam_view, device=dev)[None],
                          opt.input_size, tan, dup=32)["image"][0]
    mv = mv.cpu().numpy()
    t0 = time.perf_counter()
    model = infer.load_model(opt, device=str(dev))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)

    mha_fwd.launches = 0
    fs.composite_fwd.launches = 0
    res = infer.process(opt, mv, os.path.join(work, "big"), device=str(dev),
                        model=model)
    launches = {"mha_fwd": mha_fwd.launches,
                "composite_fwd": fs.composite_fwd.launches}

    gs, frames = res["gaussians"], res["frames"]
    n = 4 * opt.splat_size ** 2
    if gs.shape != (1, n, 14) or not np.isfinite(gs).all():
        raise AssertionError(f"gaussians {gs.shape}, finite "
                             f"{np.isfinite(gs).all()}")
    S = opt.output_size
    if frames.shape != (180, S, S, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"frames {frames.shape} {frames.dtype}")
    if not (os.path.getsize(res["ply"]) > 0
            and os.path.getsize(res["video"]) > 0):
        raise AssertionError("ply or video not written")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    # Frame 0 against the same flatsort render with K2's plain version
    # (uint8 truncation of values that agree to ~1e-4: at most 1 step),
    # and against the exact oracle for information (dup/MPT truncation).
    tg = torch.as_tensor(gs[0], device=dev)[None]
    view0 = torch.as_tensor(infer.orbit_video_cameras(opt, 180)["cam_view"][
        :1], device=dev)[None]
    with torch.inference_mode():
        params, counts = fs._prepare_view(tg[0], view0[0, 0], S, tan, 1.0,
                                          32, 32, 32, 1024, True)
        plain = fs._pack_output(
            fs.composite_reference(params, counts, 32, 32, S // 32),
            torch.ones(3, device=dev), S, 32, 32, True)["image"]
        plain = (plain.clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()
        oracle = render_views(tg, view0, S, tan, backend="reference")[
            "image"][0, 0].cpu().numpy()
        # K2 on the main path's own frame-0 slots (random-weight splats
        # are large: tiles fill to MPT), timed beside its plain version.
        args = (params, counts, 32, 32, S // 32)
        k2_ms = cuda_ms(lambda: fs.composite_fwd(*args))
        k2_plain_ms = cuda_ms(lambda: fs.composite_reference(*args), reps=5)
        k2_work = fs.composite_work(*args)
    emit("k2_main_frame0", slots_total=int(counts.sum()),
         live_pairs=k2_work["pairs"], used_pairs=k2_work["used"],
         kernel_ms=k2_ms, plain_ms=k2_plain_ms,
         bound_us=k2_bound(k2_work, params.shape[2], counts, S)[0] * 1e3)
    frame_err = int(np.abs(frames[0].astype(int) - plain.astype(int)).max())
    if frame_err > 1:
        raise AssertionError(f"frame 0 vs plain composite: {frame_err}/255")
    oracle_err = float(np.abs(frames[0] / 255.0 - oracle).mean())

    # Forward with the plain attention in place of K1, for information:
    # bf16 rounding differences through 16 attention sites.
    with mock.patch.object(unet_mod, "mha", mha_reference):
        gs_plain = infer.forward_gaussians(model, mv)
    fwd_err = float(np.abs(gs - gs_plain).max())

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer.forward_gaussians(model, mv)
        warm.append(time.perf_counter() - t0)
    emit("main", preset="big", gaussians=list(gs.shape), frames=list(
        frames.shape), ply=os.path.relpath(res["ply"], ROOT),
        video=os.path.relpath(res["video"], ROOT), load_s=load_s,
        forward_s=res["forward_s"], forward_warm_s=sorted(warm)[1],
        orbit_s=res["orbit_s"], orbit_fps=180 / res["orbit_s"],
        launches=launches, frame0_vs_plain_max=frame_err,
        frame0_vs_oracle_mean=oracle_err,
        gaussians_vs_plain_attention_max=fwd_err,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    return launches, model, mv, gs[0]


def phase_profile(dev, model, mv, gaussians):
    """Where the inference time goes: one warm forward and 30 warm orbit
    frames."""
    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS

    opt = CONFIGS["big"]
    profile_window("forward", lambda: infer.forward_gaussians(model, mv))
    profile_window("orbit30", lambda: infer.render_orbit_video(
        gaussians, opt, n_frames=30, device=str(dev)))


def phase_train(dev):
    """LGM big training at batch 2 through ``lgm_tpu_torch.train``'s own
    state, data and step functions: one cold step, five warm ones, with
    all four kernels counted; then K1ᵇ and K2ᵇ against their plain
    versions on that run's own inputs (the cold step's deepest attention
    site, and the last backward composite, view 0); then four steps in the
    CLI's default configuration (U-Net recompute on), timed with and
    without the batch's rendering; then a profile of one warm step."""
    from unittest import mock

    import numpy as np
    import torch

    from lgm_tpu_torch import train
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    # bs2 fits the 80 GB card without U-Net recompute (the preset's
    # unet_remat was a 16 GB-TPU necessity); LPIPS and bf16 as trained.
    opt = CONFIGS["big"].replace(batch_size=2, unet_remat=False)
    t0 = time.perf_counter()
    state = train.create_state(opt, dev)
    train_ds, _ = train.make_datasets(opt, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.optimizer.params)
    gen = torch.Generator().manual_seed(42)

    # Spies on the two autograd Functions' backward (not on the counted
    # wrappers) keep the step's own K1ᵇ and K2ᵇ inputs: the deepest
    # attention site and the last composite backward (view 0).
    captured = {}
    orig_mha_back = mha_mod._MHA.backward
    orig_comp_back = fs._Composite.backward

    def spy_mha_back(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if q.shape[1] >= captured.get("k1_S", 0):
            captured.update(k1=(q, k, v, o, do.contiguous(), ctx.scale),
                            k1_S=q.shape[1])
        return orig_mha_back(ctx, do)

    def spy_comp_back(ctx, go):
        params, counts, out = ctx.saved_tensors
        captured["k2"] = (params, counts, out, go.contiguous()) + ctx.tiling
        return orig_comp_back(ctx, go)

    counters = (mha_mod.mha_fwd, mha_mod.mha_bwd, fs.composite_fwd,
                fs.composite_bwd)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, data_s, losses, gnorms = [], [], [], []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = train._batch_data(train_ds.batch(i))
        bg = torch.rand(3, generator=gen).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            with mock.patch.object(mha_mod._MHA, "backward",
                                   staticmethod(spy_mha_back)), \
                    mock.patch.object(fs._Composite, "backward",
                                      staticmethod(spy_comp_back)):
                m = train.train_step(state, data, bg)
        else:
            m = train.train_step(state, data, bg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        data_s.append(t1 - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    if not np.isfinite(losses).all() or not np.isfinite(gnorms).all():
        raise AssertionError(f"non-finite loss or gnorm: {losses} {gnorms}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    warm = median(step_s[1:])
    loop_warm = median([d + s for d, s in zip(data_s[1:], step_s[1:])])
    emit("train", preset="big", batch_size=2, params=n_params,
         setup_s=setup_s, step_s=step_s[0], step_warm_s=warm,
         steps_s=step_s, data_s=data_s, train_steps_per_s=1.0 / warm,
         loop_steps_per_s=1.0 / loop_warm,
         loss=losses, gnorm=gnorms, lr=[train.current_lr(opt, i)
                                        for i in range(6)],
         peak_mem_gb=peak_gb, launches=launches)

    # The kernels on the step's own inputs (launches here are not counted
    # above: the counts were read already).
    q, k, v, o, do, scale = captured["k1"]
    with torch.no_grad():
        k1_err, k1_tol = check_k1b(q, k, v, o, do, scale, "train step")
        k1_ms = cuda_ms(lambda: mha_mod.mha_bwd(q, k, v, o, do, scale))
        params, counts, fo, go, th, tw, tiles_x = captured["k2"]
        k2_err, k2_rel = check_k2b(params, counts, fo, go, th, tw, tiles_x,
                                   "train step")
        k2_ms = cuda_ms(lambda: fs.composite_bwd(params, counts, fo, go, th,
                                                 tw, tiles_x))
        work = fs.composite_work(params, counts, th, tw, tiles_x)
    emit("train_kernels", k1_bwd_shape=list(q.shape), k1_bwd_max_abs_err=k1_err,
         k1_bwd_tol=k1_tol, k1_bwd_ms=k1_ms,
         k2_bwd_slots_total=int(counts.sum()), k2_bwd_live_pairs=work["pairs"],
         k2_bwd_used_pairs=work["used"], k2_bwd_max_abs_err=k2_err,
         k2_bwd_max_row_rel_err=k2_rel, k2_bwd_ms=k2_ms,
         k2_bwd_bound_us=k2b_bound(work, params.shape[2], counts,
                                   tw * tiles_x, params.shape[1])[0] * 1e3)
    captured.clear()
    del q, k, v, o, do, params, counts, fo, go

    # The configuration `python -m lgm_tpu_torch.train big` runs by
    # default: the preset's U-Net recompute on (the same state, the flag
    # read at each forward), batch rendering in the loop as in train.main.
    unet = state.model.lgm.unet
    unet.remat = True
    torch.cuda.reset_peak_memory_stats(dev)
    remat_s, remat_loop_s = [], []
    for i in range(6, 10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = train._batch_data(train_ds.batch(i))
        bg = torch.rand(3, generator=gen).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = train.train_step(state, data, bg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"non-finite loss with recompute: {m}")
        remat_s.append(t2 - t1)
        remat_loop_s.append(t2 - t0)
    unet.remat = False
    emit("train_cli_default", unet_remat=True, steps_s=remat_s,
         step_warm_s=median(remat_s[1:]),
         train_steps_per_s=1.0 / median(remat_s[1:]),
         loop_s=remat_loop_s, loop_steps_per_s=1.0 / median(remat_loop_s[1:]),
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)

    data = train._batch_data(train_ds.batch(10))
    bg = torch.rand(3, generator=gen).to(dev)
    profile_window("train_step", lambda: train.train_step(state, data, bg))
    return launches


def median(xs):
    """The middle value (the upper one of an even count)."""
    return sorted(xs)[len(xs) // 2]


def profile_window(name, fn):
    """torch.profiler over one call of ``fn`` (after it ran once): device
    time by kernel and the device's busy share of the window (sum of
    kernel times over the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): the operator rows of
    # key_averages() repeat the time of the kernels they launch, and the
    # trainer's named ranges appear there as spans, not kernels.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events if e.key not in SCOPES]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # Each named range (train.py, lgm.py) as a span of the device timeline,
    # from its first kernel's start to its last one's end, idle included;
    # the backward runs on autograd's own thread and gets no span.
    spans = {e.key: e.self_device_time_total / 1e3
             for e in events if e.key in SCOPES}
    emit("profile", window=name, wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms if device_ms else None,
         range_span_ms=spans,
         top=[{"kernel": k[:80], "ms": ms, "calls": n}
              for k, ms, n in rows[:15]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import lgm_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    k1b = phase_k1_bwd(dev)
    k2b = phase_k2_bwd(dev)
    infer_launches, model, mv, gaussians = phase_main(dev)
    phase_profile(dev, model, mv, gaussians)
    del model
    torch.cuda.empty_cache()
    launches = phase_train(dev)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="mha_fwd", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_fwd.cu",
             replaces="lgm_tpu/ops/mha.py:42", launches=launches["mha_fwd"],
             infer_launches=infer_launches["mha_fwd"],
             **{k: k1[k] for k in keys}),
        dict(name="composite_fwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/composite_fwd.cu",
             replaces="lgm_tpu/ops/gsplat/flatsort.py:462",
             launches=launches["composite_fwd"],
             infer_launches=infer_launches["composite_fwd"],
             **{k: k2[k] for k in keys}),
        dict(name="mha_bwd", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_bwd.cu",
             replaces="lgm_tpu/ops/mha.py:61", launches=launches["mha_bwd"],
             **{k: k1b[k] for k in keys}),
        dict(name="composite_bwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/composite_bwd.cu",
             replaces="lgm_tpu/ops/gsplat/flatsort.py:514",
             launches=launches["composite_bwd"],
             **{k: k2b[k] for k in keys}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
