#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's kernels from the sources in the checkout, holds each
against its plain PyTorch version at the shapes the main path gives it,
times both, drives the main path once (LGM ``big`` inference at full
width with seeded weights: forward -> .ply -> 180-frame orbit at 512²)
and checks that the main path launched every kernel. Each phase prints
one JSON line; any failure raises and the script exits non-zero. The
last three lines are the ``kernels`` summary, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result. Outputs of
the main path go to ``build/smoke/``.
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
# K1 tolerance: bf16 output, whose rounding step is 2^-8 of the value; the
# kernel and cuBLAS sum in different orders, so allow two steps of the
# output scale.
K1_REL_TOL = 2.0 ** -7
# K2 tolerance: f32 sums in another order (and FMA contraction), plus the
# tile early-out at T <= 1e-4, which may flip at the threshold: at most
# 1e-4 of a value <= 2.5 (the depth row).
K2_ATOL = 1e-3
# f32 operations per (pixel, slot) pair of K2 up to the alpha test
# (dx, dy, the quadratic, op * e), and per pair that accumulates (alpha,
# w, three colour and one depth FMA, the alpha sum, T update).
K2_OPS_TEST, K2_OPS_ACCUM = 14, 16


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
    with mock.patch.object(unet_mod, "mha_fwd", mha_reference):
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
    """Where the time goes: torch.profiler over one warm forward and over
    30 warm orbit frames; device time by kernel and the device's busy
    share of each window (sum of kernel times over the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS

    opt = CONFIGS["big"]
    runs = {
        "forward": lambda: infer.forward_gaussians(model, mv),
        "orbit30": lambda: infer.render_orbit_video(
            gaussians, opt, n_frames=30, device=str(dev)),
    }
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels, copies): the operator rows of
        # key_averages() repeat the time of the kernels they launch.
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0
                and not e.key.startswith("Activity Buffer")]
        rows.sort(key=lambda r: -r[1])
        device_ms = sum(r[1] for r in rows)
        emit("profile", window=name, wall_ms=wall_ms, device_ms=device_ms,
             busy_share=device_ms / wall_ms if device_ms else None,
             top=[{"kernel": k[:80], "ms": ms, "calls": n}
                  for k, ms, n in rows[:12]])


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
    launches, model, mv, gaussians = phase_main(dev)
    phase_profile(dev, model, mv, gaussians)

    kernels = [
        dict(name="mha_fwd", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_fwd.cu",
             replaces="lgm_tpu/ops/mha.py:42", launches=launches["mha_fwd"],
             **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}),
        dict(name="composite_fwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/composite_fwd.cu",
             replaces="lgm_tpu/ops/gsplat/flatsort.py:462",
             launches=launches["composite_fwd"],
             **{k: k2[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}),
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
