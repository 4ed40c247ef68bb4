#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

It builds the port's kernels from the sources in the checkout (and counts
the compositors' shuffles and shared loads in their SASS), holds each
against its plain PyTorch version at the shapes its path gives it (K2ᵇ
and K3ᵇ fed the chunk-boundary state their forward writes, and run twice
for the same bits), times both, and drives the port's three paths, each
with the launch counts set to 0 just before it and read just after (and
checked against the counts each path must give):

- inference: LGM ``big`` at full width with seeded weights, forward ->
  .ply -> 180-frame orbit at 512² (kernels K1, K2), then the orbit split
  over the host's cards (``orbit_devices``: every card, one on a one-card
  host, byte for byte the one-card video);
- training: ``lgm_tpu_torch.train`` at ``big``, batch 2, seeded weights
  and synthetic batches, one cold and three warm steps through the
  trainer's own step function (K1, K1ᵇ, K2, K2ᵇ), then K1, K1ᵇ and K2ᵇ
  held against their plain versions on that step's own inputs, then two
  steps with the U-Net recompute that ``train big`` runs by default;
- training with ``--rasterizer pallas_v1``: the same, one cold and three
  warm steps, the supervision views through the v1 tiled rasterizer (K1,
  K1ᵇ, K3, K3ᵇ; K2 for the batches' ground-truth renders), then K3 and
  K3ᵇ held against their plain versions on that step's own inputs, and
  the backend's image held against the oracle and flatsort;
- fp32 (``mixed_precision="fp32"``, the whole net in f32): K1 and K1ᵇ on
  f32 inputs (3xTF32 on wgmma fed by TMA, after the split pass that
  writes each operand's TF32 halves, itself held bit for bit against its
  plain version) at LGM big's site shapes (BH 16, 32 and 128) and a vp
  rank's lengths against their plain versions, bit-equal repeats and vp
  rows, beside SDPA at f32 (``k1_f32``); then LGM big's
  ``infer.process`` (f32 K1 16 a forward), bs2 train steps on the kernel
  route (f32 K1 and K1ᵇ 16 each a step, the split pass 32) and, from the
  same weights and batches, on the dense route forced in this process
  (peak memory and step time both ways, the two first losses held to each
  other), one warm forward and one kernel-route step profiled, and one
  step at the preset's batch of 8 with its U-Net recompute (``fp32``);
- the attention gate: the ``nano`` preset (head dim 6) trained one step
  in fp32 and in bf16, every site on the dense route, losses finite;
- the bridge from lgm_tpu's checkpoints: the committed nano ``ckpt_1``
  that ``scripts/ckpt_to_torch.py`` wrote from lgm_tpu's own, read by
  ``infer``'s and ``train``'s ``--resume`` readers in f32 with TF32 off:
  the Gaussians of the committed input and the next step's loss against
  lgm_tpu's (exact renderers on both sides: no kernel), then
  ``train.main`` resumed from it for one step (``bridge``);
- the diffusion front-end: K1 at the MV-U-Net's level-0 shapes (phase
  ``k1_diffusion``); MVDream's text path at its published widths, 4 steps
  (``diffusion_text``: K1 5 a U-Net call); and the single-image path,
  ImageDream at published widths through ``infer.image_to_views`` (30
  steps) into LGM big's ``infer.process`` (``image_to_3d``: K1 150 + 16,
  K2 180; a level-0 site and the U-Net's ε held on that run's own
  inputs; one U-Net call profiled). Weights are seeded and random; the
  tokenizer is the committed BPE fixture;
- the trainer as users run it, on disk data: the port's PNG codec
  (``png_codec``), an LVIS-layout dataset of 24 scenes x 12 views at 512²
  written by it from the port's renders (``disk_dataset``), the loader at
  LGM big's shapes with 8 worker processes (``loader``), ``train.main``
  at ``big`` on that dataset in this process under ``torchrun``'s
  one-rank environment (NCCL, DistributedDataParallel; 6 steps, the eval
  and the checkpoint, then 2 steps with ``--zero1 1``; ``train_disk``:
  the exact launches of K1, K1ᵇ, K2 and K2ᵇ a step, K1, K1ᵇ and K2ᵇ on
  the first step's own inputs), and the ``infer`` CLI in a subprocess on
  four PNG views with that checkpoint, then its entry point in this
  process on four committed 256² JPEG views, sequential and then
  progressive (``infer_cli``: K1 16, K2 180 each, the Gaussians the
  array path's on the same decoded views);
- JPEG inputs: the port's decoder (``io/jpeg.py``, host C++, sequential
  and progressive) built here and held to the committed digests of cv2's
  decode of every fixture in ``tests/fixtures/jpeg/``, every refused
  class raising, the decode time of a 512² and a 1024² 4:2:0 file of
  each kind (``jpeg_codec``);
- the multi-view diffusion finetune: K1 and K1ᵇ at its level-0 shapes
  (BH 20, S 4096 and 5120, D 64; ``k1_bwd_diffusion``), then
  ``DiffusionTrainer`` at MVDream's and at ImageDream's published widths
  (``diffusion_train``: bf16, 4 scenes x 4 frames at 256², synthetic
  frames, 6 steps; K1 5, K1ᵇ 5 a step and K2 16 a batch; K1 and K1ᵇ on
  the first step's own inputs; the U-Net gradients on the K1 route
  against dense), and its command line under ``torchrun`` on the disk
  dataset, 3 steps, its checkpoint and export read back
  (``diffusion_train_cli``). The zero-initialised output layers that
  ``from_config`` gives the U-Net, as ``lgm_tpu`` does, are drawn from a
  seed here in every diffusion phase, so that ε and the gradients reach
  every layer;
- the mesh converter (``lgm_tpu_torch.convert``) at lgm_tpu's default
  depth and widths on the bench scene's 65,536 splats: the NeRF fit,
  the mesh extraction and fit, the UV atlas, the texture fit and the
  .glb, each stage timed (``convert``: K2 once a teacher view, 896; K2 on
  a 128² and a 256² teacher view against its plain version; the
  triangle rasterizer's candidate cap and its face ids against its CPU
  path), and its command line in a subprocess, depth cut
  (``convert_cli``), and ``scripts/eval_convert_quality_torch.py`` at its
  quick budget on the torus (``convert_quality``: chamfer against the
  analytic surface, PSNR of the textured mesh against the Gaussians);
- the serving apps: the splat viewer at 512² over HTTP (``viewer_http``:
  K2 once a frame, a served frame against ``render_views``' own) and the
  upload app at LGM big (``app_http``: four PNG views POSTed twice, then
  the four JPEG views, K1 16 and K2 180 a request, the served .ply
  against the forward's).

K1 and K1ᵇ are also held at a vp rank's lengths of the view-sharded
U-Net (``vp_kernels``: LGM big's three site shapes at B = 1 and bs2, vp 2
and 4, each rank's S/vp queries against S keys, K1ᵇ with f32 dK/dV
partials; the ranks' rows against the full-length call and the vp sum of
the partials against its dK and dV, beside SDPA and the bound). A vp
world needs a card a rank, so on one card only its kernels run.

Each phase prints one JSON line; any failure raises and the script exits
non-zero. The last three lines are the ``kernels`` summary, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result. Outputs of the inference, disk-data and converter paths go to
``build/smoke/``.
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
TF32_TENSOR_FLOPS = 495e12
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
# The view-sharded U-Net's attention sites at the big preset, (BH, S, D)
# at B = 1 and bs2, each run by vp ranks of S/vp queries against S keys.
VP_SHAPES = [(BH, S, D) for BH in (16, 32)
             for S, D in ((4096, 32), (1024, 64), (256, 64))]
VP_DEGREES = (2, 4)
# The vp sum of K1ᵇ's f32 dK/dV partials against the full-length call's
# bf16 dK/dV: one bf16 step of each element, plus this share of the
# tensor's largest |value| for the f32 sums' other grouping (up to 6e-6
# measured at 4,096 keys, where a sum that cancels to near 0 can differ by
# more than a step of its own magnitude).
DKV_SUM_SCALE_TOL = 2.0 ** -16
# K1 and K1ᵇ tolerance: bf16 outputs, whose rounding step is 2^-8 of the
# value; kernel and plain version sum in different orders (and K1ᵇ's bf16
# dS and P may round the other way), so allow two steps of the scale.
K1_REL_TOL = 2.0 ** -7
# K1's row logsumexp against the plain version's: both f32, from logits
# and sums taken in other orders (and ex2.approx in the kernel): 1e-5 of
# max(1, the largest |L|).
K1_LSE_REL_TOL = 1e-5
# K1 and K1ᵇ on f32 inputs (``--mixed-precision fp32``): LGM big's three
# site shapes at B = 1 (BH 16, a forward) and bs2 (BH 32, a step), and the
# preset's batch of 8 at S 4096 (BH 128), each with its sites; and the vp
# lengths (Sq = S/2 and S/4 against S keys) at the first six.
K1_F32_SHAPES = [((BH, S, D), sites) for BH in (16, 32)
                 for (S, D), sites in (((4096, 32), 5), ((1024, 64), 5),
                                       ((256, 64), 6))] + [((128, 4096, 32),
                                                            5)]
# The f32 kernels against their plain versions (f32 matmuls, TF32 off):
# 3xTF32 products are about 2^-22 of |a b| from f32 products and the sums
# run in other orders, so o, dq, dk and dv within 1e-5 of their largest
# |value|; the statistic as the bf16 kernel's (K1_LSE_REL_TOL). The vp
# ranks' summed dK/dV partials against the full call's: the same.
K1_F32_REL_TOL = 1e-5
# The fp32 step on the kernel route against the same step on the dense
# route (same weights, batch and background): each of the 16 attention
# sites within ~1e-5 of its scale of the other route's, through the f32
# network and the loss; the losses within 1e-4 of each other.
FP32_ROUTE_LOSS_RTOL = 1e-4
# Steps of each fp32 training route at bs2: one cold, three warm (the
# median of three stands against one slow warm step).
N_FP32_STEPS = 4
# K1 in the diffusion U-Net at 256²: (BH, S, D) of the level-0 joint
# self-attention by model, BH = 2 (the CFG pair) x 5 heads, S = F x 32²,
# and its sites a U-Net call (2 on the way down, 3 on the way up); the
# single-image path's steps (lgm_tpu/infer.py:373).
K1_DIFFUSION_SHAPES = {"mvdream": (10, 4096, 64), "imagedream": (10, 5120, 64)}
DIFFUSION_SITES = 5
N_DIFFUSION_STEPS = 30
# K1 and K1ᵇ in the diffusion finetune at 256² (lgm_tpu/diffusion/train.py
# at its default batch): BH = 4 scenes x 5 heads, S = F x 32² (F = 4, and
# 5 with ImageDream's reference frame), D 64; DIFFUSION_SITES of each a
# step.
K1_TRAIN_SHAPES = {"mvdream": (20, 4096, 64), "imagedream": (20, 5120, 64)}
# The finetune phases: scenes a batch, frames, image size, steps (the
# first DIFFUSION_COLD_STEPS cold).
DIFFUSION_BATCH, DIFFUSION_FRAMES, DIFFUSION_SIZE = 4, 4, 256
DIFFUSION_TRAIN_STEPS, DIFFUSION_COLD_STEPS = 6, 2
# The ImageDream U-Net's ε on the K1 route against the gate forced dense,
# each CFG branch, relative RMS error: the two routes round P at different
# points (K1 the unnormalized P, the dense path the normalized one), up to
# 2^-7 of each site's scale; through 5 sites and the bf16 layers after
# them, at most 2^-5.
EPS_ROUTE_REL_TOL = 2.0 ** -5
# Every kernel is timed over this many calls back to back (see cuda_ms):
# its device time, which the host's time to enqueue one call (longer than
# the kernels' at S = 256) would otherwise hide; one call beside it.
K1_LAUNCHES = 10
# The compositors' times a bench view (ms) in their first design (one
# thread a pixel, one block a tile), measured by this script on NVIDIA
# H100 80GB HBM3 at 700 W over several runs, one call a sample: printed
# beside the new times.
PREVIOUS_MS = {"k2": (0.268, 0.317), "k3": (0.274, 0.301),
               "k2_bwd": (1.145, 1.227), "k3_bwd": (0.974, 1.030)}
# Streaming multiprocessors of an H100 SXM: the unit of the tile-balance
# figures (tile_balance).
N_SM = 132
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
# K3 tolerance: kernel and plain version take the power, the alpha test
# and the clamp from the same sequence of f32 roundings
# (tiled_common.cuh), so what is left is the order of the f32 sums and
# the tile early-out at T <= 1e-4 flipping at its threshold: as K2.
K3_ATOL = 1e-3
# f32 operations per (pixel, slot) pair of a live chunk of K3 up to the
# alpha test (six products and five sums of the expanded quadratic,
# op * e), and per pair that accumulates (min, w, three colour FMAs, the
# alpha sum, 1 - alpha, the T update).
K3_OPS_TEST, K3_OPS_ACCUM = 12, 11
# K3ᵇ per pair that was used: the replay (s, w, prefix, the two divisions
# of dalpha, dpower, dop, T: ~21), the ten gradient terms (9) and their
# sums over the tile's pixels (one add each, 10).
K3B_OPS_ACCUM = 40
# K3ᵇ tolerance, per gradient row, as K2ᵇ's: 1e-4 of the row's largest
# |value| (f32 sums over the tile's pixels in other orders; the suffix
# taken as U_total - prefix).
K3B_REL_TOL = 1e-4
# Rows of params_tiles that K3 and K3ᵇ read (0-6, 8-10) or write.
K3_ROWS = 10


# The program's ranges (lgm_tpu_torch/trace.py): the train step's forward
# (lgm, render, lpips inside it), backward and optimizer, the renderer's
# phases a view, the backward ranges on autograd's thread, the orbit's
# copy to the host.
SCOPES = ("loss_forward", "lgm", "render", "lpips", "loss_backward",
          "optimizer", "render.project", "render.bin", "render.gather",
          "render.composite", "render.composite.backward", "render.backward",
          "lpips.backward", "lgm.backward", "orbit.to_host")
# Steps of each training phase: one cold, the rest warm.
N_STEPS = 4

# The bridge fixture (scripts/make_bridge_fixture.py): lgm_tpu's nano
# ckpt_1 converted by scripts/ckpt_to_torch.py, and lgm_tpu's Gaussians
# and next-step loss terms from it (f32, the exact renderer). On the card
# in f32 with TF32 off the convolutions sum in other orders: the port on
# the CPU is 1.9e-5 from lgm_tpu's Gaussians (values in [-1, 1]) and 2e-6
# relative from its gradient norm, so the bounds are 10x and 50x those.
BRIDGE_DIR = os.path.join(ROOT, "tests", "fixtures", "bridge")
BRIDGE_FLAGS = ["nano", "--mixed-precision", "fp32"]
BRIDGE_GAUSSIANS_ATOL = 2e-4
BRIDGE_LOSS_RTOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2, launches: int = 1) -> float:
    """Median time of one ``fn`` in ms over ``reps`` samples (CUDA events).
    A sample spans ``launches`` calls back to back and is divided by their
    number: with 1, the host's time to enqueue the call is counted too
    wherever it exceeds the device's; with more, the host runs ahead and
    the sample is the device's time per call."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
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


def k3_bound(work: dict, T: int, P: int):
    """K3's bound from the work these inputs need: one exp and the f32
    operations per (pixel, slot) pair of the chunks composited; the ten
    rows of those chunks, the counts, pf and the [T, P, 8] output once
    each."""
    return bound(
        {"exp": work["pairs"] / SFU_EXP_PER_S,
         "f32": (K3_OPS_TEST * work["pairs"] + K3_OPS_ACCUM * work["used"])
         / F32_FLOPS},
        work["chunks"] * K3_ROWS * 128 * 4 + T * 4 + P * 8 * 4
        + T * P * 8 * 4)


def k3b_bound(work: dict, T: int, P: int, K: int):
    """K3ᵇ's bound: one exp and the f32 operations per pair; the ten rows
    of the chunks replayed, the counts, pf, fo and go read once each, and
    the [T, 16, K] gradient written."""
    return bound(
        {"exp": work["pairs"] / SFU_EXP_PER_S,
         "f32": (K3_OPS_TEST * work["pairs"] + K3B_OPS_ACCUM * work["used"])
         / F32_FLOPS},
        work["chunks"] * K3_ROWS * 128 * 4 + T * 4 + P * 8 * 4
        + 2 * T * P * 8 * 4 + T * 16 * K * 4)


def k1_bound(BH: int, Sq: int, Sk: int, D: int):
    """K1's bound for Sq queries against Sk keys: 4 BH Sq Sk D
    tensor-core flops (Q.Kᵀ, P.V), BH Sq Sk exps and ~5 f32 operations
    per logit; q, k, v read, o and the f32 row statistic written once."""
    return bound(
        {"tensor": 4.0 * BH * Sq * Sk * D / BF16_TENSOR_FLOPS,
         "exp": BH * Sq * Sk / SFU_EXP_PER_S,
         "f32": 5.0 * BH * Sq * Sk / F32_FLOPS},
        2 * BH * Sq * D * 2 + 2 * BH * Sk * D * 2 + BH * Sq * 4)


def k1b_bound(BH: int, Sq: int, Sk: int, D: int, dkv_bytes: int = 2):
    """K1ᵇ's bound for Sq queries against Sk keys: 10 BH Sq Sk D
    tensor-core flops (Q.Kᵀ, dO.Vᵀ, dS.K, dSᵀ.Q, Pᵀ.dO), BH Sq Sk exps
    and ~5 f32 operations per logit; q, o, dO, k, v and the f32 row
    statistic read, dq (bf16) and dk, dv (``dkv_bytes`` an element: 4
    for a vp rank's f32 partials) written once."""
    return bound(
        {"tensor": 10.0 * BH * Sq * Sk * D / BF16_TENSOR_FLOPS,
         "exp": BH * Sq * Sk / SFU_EXP_PER_S,
         "f32": 5.0 * BH * Sq * Sk / F32_FLOPS},
        4 * BH * Sq * D * 2 + 2 * BH * Sk * D * (2 + dkv_bytes)
        + BH * Sq * 4)


def k1_f32_bound(BH: int, Sq: int, Sk: int, D: int):
    """K1's bound at f32: the function's 4 BH Sq Sk D flops (Q.Kᵀ, P.V) at
    f32 grade, three TF32 products each (3xTF32: 12 BH Sq Sk D over the
    TF32 tensor-core peak), BH Sq Sk exps and ~5 f32 operations a logit;
    q, k, v read, o and the f32 row statistic written once, 4 bytes an
    element."""
    return bound(
        {"tensor": 12.0 * BH * Sq * Sk * D / TF32_TENSOR_FLOPS,
         "exp": BH * Sq * Sk / SFU_EXP_PER_S,
         "f32": 5.0 * BH * Sq * Sk / F32_FLOPS},
        2 * BH * Sq * D * 4 + 2 * BH * Sk * D * 4 + BH * Sq * 4)


def k1b_f32_bound(BH: int, Sq: int, Sk: int, D: int):
    """K1ᵇ's bound at f32: the function's 10 BH Sq Sk D flops (Q.Kᵀ, dO.Vᵀ,
    dS.K, dSᵀ.Q, Pᵀ.dO), three TF32 products each (30 BH Sq Sk D over the
    TF32 peak), BH Sq Sk exps and ~5 f32 operations a logit; q, o, dO, k,
    v and the statistic read, dq, dk, dv written once, all f32."""
    return bound(
        {"tensor": 30.0 * BH * Sq * Sk * D / TF32_TENSOR_FLOPS,
         "exp": BH * Sq * Sk / SFU_EXP_PER_S,
         "f32": 5.0 * BH * Sq * Sk / F32_FLOPS},
        4 * BH * Sq * D * 4 + 4 * BH * Sk * D * 4 + BH * Sq * 4)


# The split pass's operands in K1 (q, k row-major; v transposed) and in
# K1ᵇ (q, k, dO both ways; v row-major): (name, row-major, transposed).
SPLIT_FWD = (("q", True, False), ("k", True, False), ("v", False, True))
SPLIT_BWD = (("q", True, True), ("k", True, True), ("v", True, False),
             ("do", True, True))


def split_bound(BH: int, Sq: int, Sk: int, D: int, operands):
    """The split pass's bound: bytes, each operand read once and its two
    or four TF32 planes written once, 4 bytes an element (q and dO of Sq
    rows, k and v of Sk)."""
    elems = sum(BH * (Sq if name in ("q", "do") else Sk) * D
                * (1 + 2 * rows + 2 * cols) for name, rows, cols in operands)
    return bound({}, 4.0 * elems)


def rel_err(ours, ref) -> float:
    """Max abs error over the reference's largest |value|."""
    return float((ours.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def row_errors(ours, ref):
    """Max abs error over all rows, and the worst error of a row over its
    largest |value| (the K2ᵇ tolerance is per row)."""
    err = float((ours - ref).abs().max())
    rel = max(float((ours[..., r] - ref[..., r]).abs().max())
              / max(float(ref[..., r].abs().max()), 1e-30)
              for r in range(ref.shape[-1]))
    return err, rel


def check_k1(q, k, v, scale, what):
    """K1 (with its row statistic) vs its plain version; returns the
    kernel's o and lse, the max abs errors of o and lse and the
    tolerances they were held to."""
    import torch

    from lgm_tpu_torch.ops.mha import mha_fwd, mha_reference

    with torch.no_grad():
        o, lse = mha_fwd(q, k, v, scale, return_lse=True)
        ref, ref_lse = mha_reference(q, k, v, scale, return_lse=True)
    torch.cuda.synchronize()
    err = float((o.float() - ref.float()).abs().max())
    tol = K1_REL_TOL * float(ref.float().abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    lse_tol = K1_LSE_REL_TOL * max(1.0, float(ref_lse.abs().max()))
    if not (err <= tol and lse_err <= lse_tol):
        raise AssertionError(f"K1 {what}: max abs err {err} (tol {tol}), "
                             f"lse {lse_err} (tol {lse_tol})")
    return o, lse, err, tol, lse_err, lse_tol


def route_of(wrapper, run):
    """Call ``run`` and return (the route, ``run``'s result): the one
    design (``ops/mha.py::route``) that every launch of ``wrapper``
    (``mha_fwd`` or ``mha_bwd``) in it took, read from the wrapper's
    per-route counts."""
    before = dict(wrapper.route_launches)
    out = run()
    taken = sorted(r for r, n in wrapper.route_launches.items()
                   if n != before[r])
    if len(taken) != 1:
        raise AssertionError(f"{wrapper.__name__}: routes {taken} in one "
                             f"check")
    return taken[0], out


def k1_route_launches(since=None) -> dict:
    """K1's and K1ᵇ's launches by route (``mha_fwd.route_launches``,
    ``mha_bwd.route_launches``), less a reading ``since`` where given."""
    from lgm_tpu_torch.ops.mha import mha_bwd, mha_fwd

    now = {fn.__name__: dict(fn.route_launches) for fn in (mha_fwd, mha_bwd)}
    if since is None:
        return now
    return {name: {r: n - since[name][r] for r, n in counts.items()}
            for name, counts in now.items()}


def k1_site_dims(model) -> dict:
    """Head dim -> the LGM model's MVAttention sites of that head dim (LGM
    big: 5 at D 32, the S 4096 sites, and 11 at D 64)."""
    from lgm_tpu_torch.models.unet import MVAttention

    dims = {}
    for m in model.modules():
        if isinstance(m, MVAttention):
            d = m.norm.num_channels // m.num_heads
            dims[d] = dims.get(d, 0) + 1
    return dims


def check_k1_routes(what, since, dims, calls) -> dict:
    """K1's and K1ᵇ's launches by route since the reading ``since`` in an
    LGM path against what ``route`` says: each site of head dim D
    (``dims``, from ``k1_site_dims``) on ``route(D)``, ``calls[name]``
    times for wrapper ``name``. Raises where they differ; returns the
    fields a phase's line carries."""
    from lgm_tpu_torch.ops.mha import route

    got = k1_route_launches(since)
    for name, n in calls.items():
        want = dict.fromkeys(got[name], 0)
        for d, sites in dims.items():
            want[route(d)] += sites * n
        if got[name] != want:
            raise AssertionError(f"{what}: {name} launches by route "
                                 f"{got[name]}, expected {want} (sites by "
                                 f"head dim {dims})")
    return dict(k1_site_dims=dims, d32_route=route(32),
                k1_route_launches={name: got[name] for name in calls})


def check_k1b(q, k, v, o, do, scale, lse, what):
    """K1ᵇ vs its plain version, both fed K1's row statistic ``lse``;
    returns the max abs error over dq, dk, dv and the tolerance it was
    held to."""
    import torch

    from lgm_tpu_torch.ops.mha import mha_bwd, mha_bwd_reference

    ours = mha_bwd(q, k, v, o, do, scale, lse)
    ref = mha_bwd_reference(q, k, v, o, do, scale, lse)
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


def check_k2b(params, counts, fo, go, state, th, tw, tiles_x, what):
    """K2ᵇ fed K2's ``state`` vs its plain version's replay (which reads no
    state), per gradient row; two K2ᵇ runs must give the same bits.
    Returns the max abs error and the worst row's relative error."""
    import torch

    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    ours = fs.composite_bwd(params, counts, fo, go, th, tw, tiles_x,
                            state=state)
    again = fs.composite_bwd(params, counts, fo, go, th, tw, tiles_x,
                             state=state)
    ref = fs.composite_bwd_reference(params, counts, fo, go, th, tw, tiles_x)
    torch.cuda.synchronize()
    if not torch.equal(ours, again):
        raise AssertionError(f"K2ᵇ {what}: two runs differ")
    err, rel = row_errors(ours, ref)
    if not rel <= K2B_REL_TOL:
        raise AssertionError(f"K2ᵇ {what}: a row's max error is {rel} of "
                             f"its scale > {K2B_REL_TOL}")
    return err, rel


def tile_balance(tile_work, chunked: bool) -> dict:
    """How far a view's work is from an even share of N_SM SMs: the end of
    a longest-first schedule of whole tiles (one resident block an SM)
    over the even share, and the same with each tile cut into its
    128-slot chunks (when ``chunked``). ``tile_work`` holds each tile's
    visited slots."""
    import heapq

    def makespan(units):
        units = sorted((int(u) for u in units if u > 0), reverse=True)
        sms = [0] * N_SM
        for u in units:
            heapq.heappush(sms, heapq.heappop(sms) + u)
        return max(sms)

    work = [int(w) for w in tile_work.tolist()]
    even = sum(work) / N_SM
    if even == 0:
        return {"tiles_over_even": 1.0, "chunks_over_even": 1.0}
    out = {"tiles_over_even": makespan(work) / even}
    if chunked:
        chunks = [min(128, w - c0) for w in work for c0 in range(0, w, 128)]
        out["chunks_over_even"] = makespan(chunks) / even
    return out


def check_k3(params, counts, pf, what):
    """K3 vs its plain version; returns K3's output and the max abs
    error."""
    import torch

    from lgm_tpu_torch.ops.gsplat import tiled

    out = tiled.tile_composite_fwd(params, counts, pf)
    ref = tiled.tile_composite_reference(params, counts, pf)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= K3_ATOL:
        raise AssertionError(f"K3 {what}: max abs err {err} > {K3_ATOL}")
    return out, err


def check_k3b(params, counts, pf, fo, go, state, what):
    """K3ᵇ fed K3's ``state`` vs its plain version's replay (which reads no
    state), per gradient row; two K3ᵇ runs must give the same bits."""
    import torch

    from lgm_tpu_torch.ops.gsplat import tiled

    ours = tiled.tile_composite_bwd(params, counts, pf, fo, go, state)
    again = tiled.tile_composite_bwd(params, counts, pf, fo, go, state)
    ref = tiled.tile_composite_bwd_reference(params, counts, pf, fo, go)
    torch.cuda.synchronize()
    if not torch.equal(ours, again):
        raise AssertionError(f"K3ᵇ {what}: two runs differ")
    # Rows of the [T, 16, K] gradient last, as row_errors takes them.
    err, rel = row_errors(ours.transpose(1, 2), ref.transpose(1, 2))
    if not rel <= K3B_REL_TOL:
        raise AssertionError(f"K3ᵇ {what}: a row's max error is {rel} of "
                             f"its scale > {K3B_REL_TOL}")
    return err, rel


def bench_scene(dev):
    """The bench scene: 65,536 splats from ``sample_scene(seed 0)`` and
    view 0 of the 180-frame orbit, on ``dev``."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.infer import orbit_video_cameras

    g = torch.as_tensor(sample_scene(np.random.default_rng(0), 65536),
                        device=dev)
    view = torch.as_tensor(
        orbit_video_cameras(CONFIGS["big"], 180)["cam_view"][0], device=dev)
    return g, view


def launch_info(lib: str, variant, P: int, ptxas: dict) -> dict:
    """K2's or K3's launch at tiles of P pixels: its cluster size, pixels a
    thread, threads a block and the ptxas report (registers, stack, spills)
    of that instantiation in library ``lib``."""
    from lgm_tpu_torch.ops.gsplat.flatsort import launch_shape

    cs, ppt = launch_shape(P, variant)
    return dict(cluster=cs, pixels_per_thread=ppt,
                threads=P // (cs * ppt),
                ptxas=ptxas.get(lib, {}).get(f"{lib}_kernel<{cs},{ppt}>"))


def ptxas_summary(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel in a ``ptxas
    -v`` log, by kernel name and template arguments
    (``mha_fwd_kernel<32,2,4>``)."""
    import re

    from lgm_tpu_torch.ops._build import short_name

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = short_name(entry.group(1))
            out[name] = {}
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        stack = re.search(r"(\d+) bytes stack frame", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and stack:
            out[name]["stack_frame"] = int(stack.group(1))
        if name and spill:
            out[name]["spill_stores"] = int(spill.group(1))
            out[name]["spill_loads"] = int(spill.group(2))
        if name and regs:
            out[name]["registers"] = int(regs.group(1))
    return out


def phase_build():
    from lgm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_summary(so.with_name(so.name + ".log").read_text())
             for name, so in libs.items()}
    # Static SHFL and LDS counts of the compositors (None without
    # cuobjdump).
    sass = {name: _build.sass_counts(libs[name])
            for name in ("composite_fwd", "composite_bwd", "tiled_fwd",
                         "tiled_bwd")}
    # The wgmma kernels' registers and spills (none allowed), bf16 and f32
    # (with the f32 split pass).
    wgmma = {kernel: report for name in (
        "mha_fwd_wgmma", "mha_bwd_wgmma", "mha_fwd_f32", "mha_bwd_f32",
        "mha_split_tf32") for kernel, report in ptxas[name].items()}
    spilled = {k: r for k, r in wgmma.items()
               if r["spill_stores"] or r["spill_loads"] or r["stack_frame"]}
    if spilled:
        raise AssertionError(f"wgmma kernels spill: {spilled}")
    # The f32 kernels' tensor-core instructions: TF32 wgmma (HGMMA ..
    # .TF32) in every kernel, no Ampere mma.sync m16n8k8 (HMMA.1688) left;
    # None without cuobjdump.
    f32_sass = {name: _build.sass_mma_counts(libs[name])
                for name in ("mha_fwd_f32", "mha_bwd_f32")}
    bad = {name: counts for name, counts in f32_sass.items()
           if counts is not None and not all(
               c["HGMMA_TF32"] > 0 and c["HMMA_1688"] == 0
               for c in counts.values())}
    if bad:
        raise AssertionError(f"f32 kernels off TF32 wgmma: {bad}")
    emit("build", seconds=seconds, kernels=sorted(libs), ptxas=ptxas,
         sass=sass, wgmma_ptxas=wgmma, f32_sass=f32_sass)
    return ptxas


def phase_k1(dev):
    """K1 with its row statistic at the three (BH, S, D) of one B = 1
    forward (``K1_SHAPES``) and of the bs2 train step (``K1B_SHAPES``),
    against its plain version and beside SDPA's forward. Returns the
    per-forward sums for the ``kernels`` line and the per-step sums."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import mha_fwd, mha_reference

    sums = {}
    for per, shapes in (("forward", K1_SHAPES), ("step", K1B_SHAPES)):
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        worst_err, bound_by = 0.0, "operations"
        for (BH, S, D), sites in shapes:
            rng = np.random.default_rng(S + D)
            q, k, v = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            scale = float(D) ** -0.5
            route, (_, _, err, tol, lse_err, lse_tol) = route_of(
                mha_fwd, lambda: check_k1(q, k, v, scale, f"{BH}x{S}x{D}"))
            with torch.inference_mode():
                # Device times (K1_LAUNCHES back to back); in training the
                # kernel writes the statistic too.
                ms = cuda_ms(lambda: mha_fwd(q, k, v, scale,
                                             return_lse=per == "step"),
                             launches=K1_LAUNCHES)
                plain_ms = cuda_ms(lambda: mha_reference(q, k, v, scale))
                sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], scale=scale),
                    launches=K1_LAUNCHES)
            b_ms, b_by = k1_bound(BH, S, S, D)
            emit("k1", per=per, shape=[BH, S, D], sites=sites, route=route,
                 max_abs_err=err, tol=tol, lse_max_abs_err=lse_err,
                 lse_tol=lse_tol, kernel_ms=ms, plain_ms=plain_ms,
                 library_ms=sdpa_ms, kernel_over_library=ms / sdpa_ms,
                 bound_us=b_ms * 1e3, bound_by=b_by)
            worst_err = max(worst_err, err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", sdpa_ms), ("bound_ms", b_ms)):
                total[key] += sites * val
            if S == 4096:
                bound_by = b_by
        sums[per] = dict(max_abs_err=worst_err, bound_by=bound_by, **total)
    emit("k1_sums", **{f"{per}_{key}": val for per, d in sums.items()
                       for key, val in d.items()},
         forward_kernel_over_library=sums["forward"]["ms"]
         / sums["forward"]["library_ms"],
         step_kernel_over_library=sums["step"]["ms"]
         / sums["step"]["library_ms"])
    return sums["forward"]


def bf16_steps(a, b, slack: float = 0.0) -> float:
    """The largest |a - b| over the bf16 rounding step at the larger of
    the two magnitudes plus ``slack`` of b's largest |value|, elementwise
    (1.0: one step)."""
    import torch

    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), e - 8) + slack * b.abs().max()
    return float(((a - b).abs() / step).max())


def phase_vp_kernels(dev):
    """K1 and K1ᵇ on each rank of a vp group of the view-sharded U-Net:
    at LGM big's three site shapes (``VP_SHAPES``: B = 1 and bs2) for vp
    2 and 4, each rank's S/vp queries against all S keys, on seeded
    inputs. Each rank's K1 and K1ᵇ (f32 dK/dV partials) against their
    plain versions; its o, lse and dq rows against the full-length call
    (bit for bit expected: a row's arithmetic reads its own q row and
    every key in the same order); the vp sum of the f32 partials, rounded
    once, against the full call's dK and dV (within one bf16 step
    expected). Rank 0's shapes timed (device time over K1_LAUNCHES calls)
    beside SDPA's forward and backward at the same (Sq, Sk) and the bound.
    A vp world needs a card a rank (NCCL takes one rank a device), so on
    one card only its kernels run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import (_sms, launch_plan, mha_bwd,
                                       mha_bwd_reference, mha_fwd,
                                       mha_reference)

    fwd_rows, bwd_rows = [], []
    for (BH, S, D), vp in ((shape, vp) for shape in VP_SHAPES
                           for vp in VP_DEGREES):
        rng = np.random.default_rng(BH * S + D + vp)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(D) ** -0.5
        n = S // vp
        worst = dict(fwd=0.0, fwd_tol=0.0, lse=0.0, bwd=0.0, bwd_tol=0.0)
        rows_equal = dict(o=True, lse=True, dq=True)
        # The route of every call, the full one's and each rank's: one.
        taken = set()
        with torch.no_grad():
            route, (o, lse) = route_of(mha_fwd, lambda: mha_fwd(
                q, k, v, scale, return_lse=True))
            taken.add(route)
            route, (dq, dk, dv) = route_of(mha_bwd, lambda: mha_bwd(
                q, k, v, o, do, scale, lse))
            taken.add(route)
            dk_sum = torch.zeros(BH, S, D, device=dev)
            dv_sum = torch.zeros(BH, S, D, device=dev)
            for r in range(vp):
                rows = slice(r * n, (r + 1) * n)
                q_r, do_r = q[:, rows].contiguous(), do[:, rows].contiguous()
                route, (o_r, lse_r, err, tol, lse_err, _) = route_of(
                    mha_fwd, lambda: check_k1(
                        q_r, k, v, scale,
                        f"vp{vp} rank {r} {BH}x{n}x{S}x{D}"))
                taken.add(route)
                route, ours = route_of(mha_bwd, lambda: mha_bwd(
                    q_r, k, v, o_r, do_r, scale, lse_r, dkv_f32=True))
                taken.add(route)
                ref = mha_bwd_reference(q_r, k, v, o_r, do_r, scale, lse_r,
                                        dkv_f32=True)
                torch.cuda.synchronize()
                for name, a, b in zip(("dq", "dk32", "dv32"), ours, ref):
                    b_err = float((a.float() - b.float()).abs().max())
                    b_tol = K1_REL_TOL * float(b.float().abs().max())
                    if not (a.dtype == b.dtype and b_err <= b_tol):
                        raise AssertionError(
                            f"K1ᵇ vp{vp} rank {r} {BH}x{n}x{S}x{D} {name}: "
                            f"max abs err {b_err} > {b_tol}")
                    if b_err >= worst["bwd"]:
                        worst.update(bwd=b_err, bwd_tol=b_tol)
                if err >= worst["fwd"]:
                    worst.update(fwd=err, fwd_tol=tol)
                worst["lse"] = max(worst["lse"], lse_err)
                rows_equal["o"] &= torch.equal(o_r, o[:, rows])
                rows_equal["lse"] &= torch.equal(lse_r, lse[:, rows])
                rows_equal["dq"] &= torch.equal(ours[0], dq[:, rows])
                dk_sum += ours[1]
                dv_sum += ours[2]
            dkv_steps = max(bf16_steps(dk_sum.to(torch.bfloat16), dk),
                            bf16_steps(dv_sum.to(torch.bfloat16), dv))
            dkv_held = max(
                bf16_steps(dk_sum.to(torch.bfloat16), dk, DKV_SUM_SCALE_TOL),
                bf16_steps(dv_sum.to(torch.bfloat16), dv, DKV_SUM_SCALE_TOL))
            dkv_err = max(float((dk_sum.to(torch.bfloat16).float()
                                 - dk.float()).abs().max()),
                          float((dv_sum.to(torch.bfloat16).float()
                                 - dv.float()).abs().max()))
            if not (all(rows_equal.values()) and dkv_held <= 1.0
                    and len(taken) == 1):
                raise AssertionError(
                    f"vp{vp} {BH}x{S}x{D}: routes {taken}, rows bit-equal "
                    f"{rows_equal}, "
                    f"dK/dV sum {dkv_held} bf16 steps (with the f32 "
                    f"regrouping's allowance) from the full call")
            q_r, do_r = q[:, :n].contiguous(), do[:, :n].contiguous()
            o_r, lse_r = mha_fwd(q_r, k, v, scale, return_lse=True)
            ms = cuda_ms(lambda: mha_fwd(q_r, k, v, scale, return_lse=True),
                         launches=K1_LAUNCHES)
            plain_ms = cuda_ms(lambda: mha_reference(q_r, k, v, scale),
                               reps=3)
            b_ms = cuda_ms(lambda: mha_bwd(q_r, k, v, o_r, do_r, scale,
                                           lse_r, dkv_f32=True),
                           launches=K1_LAUNCHES)
            b_plain_ms = cuda_ms(lambda: mha_bwd_reference(
                q_r, k, v, o_r, do_r, scale, lse_r, dkv_f32=True), reps=3)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q_r[None], k[None], v[None], scale=scale),
                launches=K1_LAUNCHES)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q_r, k, v))
        out = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do_r[None], retain_graph=True),
            launches=K1_LAUNCHES)
        del out, qs, ks, vs
        plan = launch_plan(BH, n, S, D, _sms(dev))
        f_bound, f_by = k1_bound(BH, n, S, D)
        bw_bound, bw_by = k1b_bound(BH, n, S, D, dkv_bytes=4)
        common = dict(shape=[BH, S, D], vp=vp, Sq=n, Sk=S)
        emit("vp_kernels", **common,
             route=taken.pop(), blocks=dict(
                 fwd=plan["fwd"], dq=plan["dq"], dkv=plan["dkv"],
                 dkv_query_tile=128 if n % 128 == 0 else 64),
             k1_max_abs_err=worst["fwd"], k1_tol=worst["fwd_tol"],
             lse_max_abs_err=worst["lse"], k1b_max_abs_err=worst["bwd"],
             k1b_tol=worst["bwd_tol"], rows_bit_equal=rows_equal,
             dkv_sum_max_abs_err=dkv_err, dkv_sum_bf16_steps=dkv_steps,
             dkv_sum_steps_with_allowance=dkv_held,
             dkv_sum_allowance=DKV_SUM_SCALE_TOL,
             k1_ms=ms, k1_plain_ms=plain_ms, sdpa_ms=sdpa_ms,
             k1_over_library=ms / sdpa_ms, k1_bound_us=f_bound * 1e3,
             k1_bound_by=f_by, k1b_ms=b_ms, k1b_plain_ms=b_plain_ms,
             sdpa_bwd_ms=sdpa_bwd_ms, k1b_over_library=b_ms / sdpa_bwd_ms,
             k1b_bound_us=bw_bound * 1e3, k1b_bound_by=bw_by)
        fwd_rows.append(dict(**common, max_abs_err=worst["fwd"], ms=ms,
                             plain_ms=plain_ms, library_ms=sdpa_ms,
                             bound_ms=f_bound, bound_by=f_by,
                             rows_bit_equal=rows_equal["o"]))
        bwd_rows.append(dict(**common, max_abs_err=worst["bwd"], ms=b_ms,
                             plain_ms=b_plain_ms, library_ms=sdpa_bwd_ms,
                             bound_ms=bw_bound, bound_by=bw_by,
                             dq_rows_bit_equal=rows_equal["dq"],
                             dkv_sum_bf16_steps=dkv_steps))
    return fwd_rows, bwd_rows


def phase_orbit_devices(dev, gaussians):
    """The orbit split over the host's cards (``render_orbit_video`` with
    ``n_devices`` = ``torch.cuda.device_count()``) against one card, byte
    for byte, and K2 once a frame either way. On a one-card host both are
    the one-card path; the line says how many cards there were."""
    import numpy as np
    import torch

    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    opt = CONFIGS["big"]
    count = torch.cuda.device_count()
    videos, launches, secs = [], [], []
    for n in (count, 1):
        fs.composite_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        videos.append(infer.render_orbit_video(gaussians, opt,
                                               device=str(dev), n_devices=n))
        secs.append(time.perf_counter() - t0)
        launches.append(fs.composite_fwd.launches)
    if not (np.array_equal(videos[0], videos[1])
            and launches == [180, 180]):
        raise AssertionError(f"orbit over {count} cards: equal "
                             f"{np.array_equal(videos[0], videos[1])}, K2 "
                             f"launches {launches}")
    emit("orbit_devices", cards=count,
         note=("one card: the split is the one-card path" if count == 1
               else f"frames split over {count} cards"),
         n_devices=infer.orbit_split(180, 30, False, None, dev)[0],
         frames_equal_one_card=True, k2_launches=launches[0],
         orbit_s=secs[0], one_card_orbit_s=secs[1])


def phase_k2(dev, ptxas):
    """K2 on the bench scene (view 0, 512², 65,536 splats, with depth as
    inference runs it) against its plain version, timed as device time
    (K1_LAUNCHES calls) and one call."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    opt = CONFIGS["big"]
    S, th, tw, dup, mpt = opt.output_size, 32, 32, 32, 1024
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g, view = bench_scene(dev)
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
        ms = cuda_ms(lambda: fs.composite_fwd(*args), launches=K1_LAUNCHES)
        one_call_ms = cuda_ms(lambda: fs.composite_fwd(*args))
        plain_ms = cuda_ms(lambda: fs.composite_reference(*args), reps=5)
        work = fs.composite_work(*args)
    b_ms, b_by = k2_bound(work, params.shape[2], counts, S)
    tile_slots = work["tile_slots"].float()
    emit("k2", tiles=int(params.shape[0]), splats=65536, image=S, dup=dup,
         slots_total=int(counts.sum()), live_pairs=work["pairs"],
         used_pairs=work["used"], tile_slots_max=int(tile_slots.max()),
         tile_slots_mean=float(tile_slots.mean()),
         balance=tile_balance(work["tile_slots"], chunked=False),
         **launch_info("composite_fwd", fs.K2_VARIANT, th * tw, ptxas),
         max_abs_err=err, tol=K2_ATOL, kernel_ms=ms,
         kernel_one_call_ms=one_call_ms,
         was_kernel_one_call_ms=PREVIOUS_MS["k2"], plain_ms=plain_ms,
         bound_us=b_ms * 1e3, bound_by=b_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# The backward projection kernel against its plain version: f32 sums in
# other orders and contracted into fmas, as a share of each gradient
# column's largest |value| (tests/test_torch_kernels_gpu.py).
PROJECT_BWD_COL_TOL = 2.0 ** -15


def projection_bytes(N: int, R: int) -> dict:
    """Bytes the projection kernels must move for N splats and R slot rows:
    the forward reads the rows (14 f32) and writes mean2d, conic, depth,
    the three radii, valid (1 byte) and the slot rows; the backward reads
    the rows and the rows' cotangent and writes the gradient (14 f32). The
    view's 64 bytes are left out."""
    return {"fwd": N * (4 * 14 + 4 * (2 + 3 + 1 + 3 + R) + 1),
            "bwd": N * (4 * 14 + 4 * R + 4 * 14)}


def kernel_device_us(fn, name: str, calls: int = K1_LAUNCHES) -> float:
    """Mean device time (us) of the kernels whose name holds ``name`` over
    ``calls`` calls of ``fn``, from a ``torch.profiler`` trace: the
    kernel's own time, where ``cuda_ms`` of a call this short measures the
    host's enqueue."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            total += getattr(e, "self_device_time_total", None) or \
                e.self_cuda_time_total
            n += e.count
    if n != calls:
        raise AssertionError(f"{name}: {n} kernels traced over {calls} calls")
    return total / n


def phase_projection(dev):
    """The projection kernels (``csrc/project_fwd.cu``, ``project_bwd.cu``)
    on the train cell's scene shape, 65,536 splats at 512², through the
    bench view with the depth row (R = 10, as the orbit runs it) and a
    train camera without (R = 9, as the train step runs it): the forward
    against ``project_gaussians`` bit for bit on every field, the backward
    against ``project_gaussians_bwd_reference`` (column-wise, within
    ``PROJECT_BWD_COL_TOL``) and for the same bits on a second call; each
    kernel timed by the profiler (its device time alone), over K1_LAUNCHES
    calls back to back (the wrapper's host time bounds those) and one call,
    beside the plain chain's forward and its autograd backward, one call
    each, and the bound by bytes."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_poses
    from lgm_tpu_torch.ops.gsplat import projection as pj
    from lgm_tpu_torch.utils import camera

    opt = CONFIGS["big"]
    S = opt.output_size
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g, bench_view = bench_scene(dev)
    train_view = torch.as_tensor(camera.build_camera_inputs(
        sample_poses(np.random.default_rng(21), opt), opt.fovy, opt.znear,
        opt.zfar)["cam_view"][opt.num_input_views + 1], dtype=torch.float32,
        device=dev)
    N = g.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for cam, view, with_depth in (("bench", bench_view, True),
                                  ("train", train_view, False)):
        R = 10 if with_depth else 9
        args = (g, view, S, tan, 1.0)
        with torch.no_grad():
            ours = pj.project_fwd(*args, with_depth)
            ref = pj.project_gaussians(*args, with_depth)
            torch.cuda.synchronize()
            unequal = {f: int((getattr(ours, f) != getattr(ref, f)).sum())
                       for f in pj.Projected._fields}
            if any(unequal.values()):
                raise AssertionError(f"projection forward ({cam}): elements "
                                     f"not bit for bit {unequal}")
            g_attrs = torch.randn(N, R, generator=gen, device=dev).T
            grad = pj.project_bwd(*args, g_attrs)
            again = pj.project_bwd(*args, g_attrs)
            plain_grad = pj.project_gaussians_bwd_reference(*args, g_attrs)
            torch.cuda.synchronize()
            scale = plain_grad.abs().amax(dim=0)
            col_err = float(((grad - plain_grad).abs().amax(dim=0)
                             / scale).max())
            if not col_err <= PROJECT_BWD_COL_TOL:
                raise AssertionError(f"projection backward ({cam}): column "
                                     f"error {col_err} > "
                                     f"{PROJECT_BWD_COL_TOL}")
            bitwise_repeat = bool(torch.equal(grad, again))
            if not bitwise_repeat:
                raise AssertionError(f"projection backward ({cam}): two "
                                     f"calls differ")
            fwd_ms = cuda_ms(lambda: pj.project_fwd(*args, with_depth),
                             launches=K1_LAUNCHES)
            fwd_one_ms = cuda_ms(lambda: pj.project_fwd(*args, with_depth))
            bwd_ms = cuda_ms(lambda: pj.project_bwd(*args, g_attrs),
                             launches=K1_LAUNCHES)
            bwd_one_ms = cuda_ms(lambda: pj.project_bwd(*args, g_attrs))
            fwd_us = kernel_device_us(
                lambda: pj.project_fwd(*args, with_depth),
                "project_fwd_kernel")
            bwd_us = kernel_device_us(
                lambda: pj.project_bwd(*args, g_attrs), "project_bwd_kernel")
            plain_fwd_ms = cuda_ms(
                lambda: pj.project_gaussians(*args, with_depth), reps=5)
            reference_bwd_ms = cuda_ms(
                lambda: pj.project_gaussians_bwd_reference(*args, g_attrs),
                reps=5)
        gl = g.clone().requires_grad_()
        attrs_t = pj.project_gaussians(gl, *args[1:], with_depth).attrs_t
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            attrs_t, gl, g_attrs, retain_graph=True), reps=5)
        del attrs_t
        nbytes = projection_bytes(N, R)
        fwd_bound, fwd_by = bound({}, nbytes["fwd"])
        bwd_bound, bwd_by = bound({}, nbytes["bwd"])
        emit("projection", camera=cam, splats=N, image=S, rows=R,
             valid=int(ref.valid.sum()), bit_for_bit=True,
             bwd_col_err=col_err, tol=PROJECT_BWD_COL_TOL,
             bitwise_repeat=bitwise_repeat, fwd_device_us=fwd_us,
             bwd_device_us=bwd_us, fwd_kernel_ms=fwd_ms,
             fwd_kernel_one_call_ms=fwd_one_ms, bwd_kernel_ms=bwd_ms,
             bwd_kernel_one_call_ms=bwd_one_ms, plain_fwd_ms=plain_fwd_ms,
             plain_bwd_ms=plain_bwd_ms, reference_bwd_ms=reference_bwd_ms,
             fwd_bytes=nbytes["fwd"], bwd_bytes=nbytes["bwd"],
             fwd_bound_us=fwd_bound * 1e3, bwd_bound_us=bwd_bound * 1e3,
             bound_by=fwd_by if fwd_by == bwd_by else f"{fwd_by}/{bwd_by}")
        out[cam] = dict(max_abs_err=0.0, ms=fwd_us / 1e3,
                        plain_ms=plain_fwd_ms, bound_ms=fwd_bound,
                        bound_by=fwd_by, library_ms=None,
                        bwd=dict(max_col_err=col_err, ms=bwd_us / 1e3,
                                 plain_ms=plain_bwd_ms, bound_ms=bwd_bound,
                                 bound_by=bwd_by))
    return out


def phase_k1_bwd(dev):
    """K1ᵇ at the three (BH, S, D) of the big bs2 train step, fed K1's
    row statistic, against its plain version and beside the backward of
    SDPA (through autograd, from SDPA's own stored statistics)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import mha_bwd, mha_bwd_reference, mha_fwd

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst_err, bound_by = 0.0, "operations"
    for (BH, S, D), sites in K1B_SHAPES:
        rng = np.random.default_rng(7 * S + D)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(D) ** -0.5
        with torch.no_grad():
            o, lse = mha_fwd(q, k, v, scale, return_lse=True)
            route, (err, tol) = route_of(mha_bwd, lambda: check_k1b(
                q, k, v, o, do, scale, lse, f"{BH}x{S}x{D}"))
            ms = cuda_ms(lambda: mha_bwd(q, k, v, o, do, scale, lse),
                         launches=K1_LAUNCHES)
            plain_ms = cuda_ms(lambda: mha_bwd_reference(q, k, v, o, do,
                                                         scale, lse), reps=5)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do[None], retain_graph=True),
            launches=K1_LAUNCHES)
        del out, qs, ks, vs
        b_ms, b_by = k1b_bound(BH, S, S, D)
        emit("k1_bwd", shape=[BH, S, D], sites=sites, route=route,
             max_abs_err=err,
             tol=tol, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             kernel_over_library=ms / lib_ms, bound_us=b_ms * 1e3,
             bound_by=b_by)
        worst_err = max(worst_err, err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms)):
            total[key] += sites * val
        if S == 4096:
            bound_by = b_by
    emit("k1_bwd_sums", **total,
         step_kernel_over_library=total["ms"] / total["library_ms"])
    return dict(max_abs_err=worst_err, bound_by=bound_by, **total)


def phase_k1_f32(dev, ptxas=None):
    """K1 and K1ᵇ on f32 inputs (``mha_fwd_f32``, ``mha_bwd_f32``, reached
    through ``mha_fwd`` / ``mha_bwd`` as the fp32 path reaches them) at
    ``K1_F32_SHAPES``, on seeded inputs: each against its plain version at
    f32 (TF32 off) within K1_F32_REL_TOL, a second call bit for bit the
    first, the launches counted by the f32 wrappers alone; device time
    (median of 10 CUDA-event samples of K1_LAUNCHES calls) beside SDPA's
    forward and backward at f32 on the same inputs and the bound. Then
    the vp lengths at the B = 1 and bs2 shapes: each rank's S/vp queries
    (vp 2 and 4) against S keys, its o, lse and dq rows bit for bit the
    full call's, its f32 dK/dV partials summed over the ranks within
    K1_F32_REL_TOL of the full call's, rank 0 timed. The split pass that
    each f32 K1 and K1ᵇ launch runs first (``mha_split_tf32``: 4 launches
    in a shape's check) is held bit for bit against its plain version on
    K1ᵇ's operands and timed alone on each kernel's operands (inside their
    ``kernel_ms``), beside its bytes bound. Returns the ``kernels`` line's
    fields: the f32 K1 summed over a B = 1 forward's sites, K1ᵇ over a bs2
    step's, and the split pass over a bs2 step's 32 launches. ``ptxas``
    (phase ``build``'s reports) is printed where given."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import (_sms, _split, launch_plan, mha_bwd,
                                       mha_bwd_f32, mha_bwd_reference,
                                       mha_fwd, mha_fwd_f32, mha_reference,
                                       mha_split_tf32, split_tf32_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    if ptxas is not None:
        emit("k1_f32_ptxas", **{name: ptxas[name] for name in (
            "mha_fwd_f32", "mha_bwd_f32", "mha_split_tf32")})
    sums = {per: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      max_abs_err=0.0, bound_by="operations")
            for per in ("forward", "step")}
    # The split pass inside a bs2 fp32 step: its launch in each K1 (the
    # forward's operands) and each K1ᵇ (the backward's).
    split = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                 max_abs_err=0.0, bound_by="bytes")

    def split_of(tensors, operands):
        return [(tensors[name], rows, cols) for name, rows, cols in operands]
    shapes = []
    for (BH, S, D), sites in K1_F32_SHAPES:
        rng = np.random.default_rng(BH + S + D)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       for _ in range(4))
        scale = float(D) ** -0.5
        wrappers = (mha_fwd_f32, mha_bwd_f32, mha_fwd, mha_bwd,
                    mha_split_tf32)
        counts = [fn.launches for fn in wrappers]
        with torch.no_grad():
            o, lse = mha_fwd(q, k, v, scale, return_lse=True)
            again = mha_fwd(q, k, v, scale, return_lse=True)
            grads = mha_bwd(q, k, v, o, do, scale, lse)
            twice = mha_bwd(q, k, v, o, do, scale, lse)
            torch.cuda.synchronize()
            launched = [fn.launches - n for fn, n in zip(wrappers, counts)]
            bitwise = (torch.equal(again[0], o) and torch.equal(again[1], lse)
                       and all(torch.equal(a, b) for a, b in zip(grads,
                                                                  twice)))
            del again, twice
            ref, ref_lse = mha_reference(q, k, v, scale, return_lse=True)
            err = rel_err(o, ref)
            abs_err = float((o - ref).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            lse_tol = K1_LSE_REL_TOL * max(1.0, float(ref_lse.abs().max()))
            del ref, ref_lse
            plain = mha_bwd_reference(q, k, v, o, do, scale, lse)
            b_errs = {name: rel_err(a, b) for name, a, b in
                      zip(("dq", "dk", "dv"), grads, plain)}
            b_abs = max(float((a - b).abs().max())
                        for a, b in zip(grads, plain))
            del plain
            torch.cuda.empty_cache()
            if not (launched == [2, 2, 0, 0, 4] and bitwise
                    and err <= K1_F32_REL_TOL and lse_err <= lse_tol
                    and max(b_errs.values()) <= K1_F32_REL_TOL
                    and o.dtype == lse.dtype == grads[0].dtype
                    == torch.float32):
                raise AssertionError(
                    f"f32 K1/K1ᵇ {BH}x{S}x{D}: launches (f32 fwd, f32 bwd, "
                    f"bf16 fwd, bf16 bwd, split) {launched}, bit-equal repeat "
                    f"{bitwise}, o {err} (tol {K1_F32_REL_TOL}), lse "
                    f"{lse_err} (tol {lse_tol}), grads {b_errs}")
            # In inference (B = 1) the forward writes no statistic; in
            # training it does.
            ms = cuda_ms(lambda: mha_fwd(q, k, v, scale,
                                         return_lse=BH != 16),
                         launches=K1_LAUNCHES)
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, scale), reps=3)
            b_ms = cuda_ms(lambda: mha_bwd(q, k, v, o, do, scale, lse),
                           launches=K1_LAUNCHES)
            b_plain_ms = cuda_ms(lambda: mha_bwd_reference(
                q, k, v, o, do, scale, lse), reps=3)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale),
                launches=K1_LAUNCHES)
            # The split pass alone, bit for bit its plain version on the
            # backward's operands (every kind of plane), and timed on the
            # operands of each kernel (inside the kernel_ms above).
            named = dict(q=q, k=k, v=v, do=do)
            planes = mha_split_tf32(split_of(named, SPLIT_BWD))
            split_bitwise = all(
                torch.equal(got[key].view(torch.int32),
                            want[key].view(torch.int32))
                for (x, rows, cols), got in zip(
                    split_of(named, SPLIT_BWD), planes)
                for want in (split_tf32_reference(x, rows, cols),)
                for key in want)
            del planes
            if not split_bitwise:
                raise AssertionError(f"split pass {BH}x{S}x{D}: not bit "
                                     f"for bit its plain version")
            # Timed as the kernels' wrappers launch it (``_split``: no
            # views, no second check of the operands).
            stream = torch.cuda.current_stream(dev).cuda_stream
            split_ms = {per: cuda_ms(lambda ops=ops: _split(
                split_of(named, ops), BH, D, dev, stream),
                launches=K1_LAUNCHES)
                for per, ops in (("fwd", SPLIT_FWD), ("bwd", SPLIT_BWD))}
            split_plain_ms = {per: cuda_ms(lambda ops=ops: [
                split_tf32_reference(x, r, c)
                for x, r, c in split_of(named, ops)], reps=3)
                for per, ops in (("fwd", SPLIT_FWD), ("bwd", SPLIT_BWD))}
            split_bounds = {per: split_bound(BH, S, S, D, ops)[0]
                            for per, ops in (("fwd", SPLIT_FWD),
                                             ("bwd", SPLIT_BWD))}
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do[None], retain_graph=True),
            launches=K1_LAUNCHES)
        del out, qs, ks, vs
        if BH == 32:
            for key, vals in (("ms", split_ms), ("plain_ms", split_plain_ms),
                              ("bound_ms", split_bounds)):
                split[key] += sites * (vals["fwd"] + vals["bwd"])
        f_bound, f_by = k1_f32_bound(BH, S, S, D)
        bw_bound, bw_by = k1b_f32_bound(BH, S, S, D)
        plan = launch_plan(BH, S, S, D, _sms(dev), torch.float32)
        emit("k1_f32", shape=[BH, S, D], sites=sites, plan=plan,
             max_abs_err=abs_err, max_rel_err=err, tol_rel=K1_F32_REL_TOL,
             lse_max_abs_err=lse_err, lse_tol=lse_tol, bitwise_repeat=True,
             kernel_ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
             kernel_over_library=ms / sdpa_ms, bound_us=f_bound * 1e3,
             bound_by=f_by, share_of_bound=f_bound / ms,
             split_launches=1, split_ms=split_ms["fwd"],
             split_plain_ms=split_plain_ms["fwd"],
             split_bound_us=split_bounds["fwd"] * 1e3,
             split_bitwise=split_bitwise)
        emit("k1_bwd_f32", shape=[BH, S, D], sites=sites, plan=plan,
             max_abs_err=b_abs, max_rel_err=b_errs, tol_rel=K1_F32_REL_TOL,
             bitwise_repeat=True, kernel_ms=b_ms, plain_ms=b_plain_ms,
             library_ms=sdpa_bwd_ms, kernel_over_library=b_ms / sdpa_bwd_ms,
             bound_us=bw_bound * 1e3, bound_by=bw_by,
             share_of_bound=bw_bound / b_ms, split_launches=1,
             split_ms=split_ms["bwd"], split_plain_ms=split_plain_ms["bwd"],
             split_bound_us=split_bounds["bwd"] * 1e3)
        shapes.append(dict(shape=[BH, S, D], sites=sites, k1_ms=ms,
                           k1b_ms=b_ms, sdpa_ms=sdpa_ms,
                           sdpa_bwd_ms=sdpa_bwd_ms, k1_bound_ms=f_bound,
                           k1b_bound_ms=bw_bound,
                           split_fwd_ms=split_ms["fwd"],
                           split_bwd_ms=split_ms["bwd"]))
        for per, BH_per, vals in (
                ("forward", 16, (ms, plain_ms, sdpa_ms, f_bound, abs_err,
                                 f_by)),
                ("step", 32, (b_ms, b_plain_ms, sdpa_bwd_ms, bw_bound,
                              b_abs, bw_by))):
            if BH != BH_per:
                continue
            total = sums[per]
            for key, val in zip(("ms", "plain_ms", "library_ms",
                                 "bound_ms"), vals[:4]):
                total[key] += sites * val
            total["max_abs_err"] = max(total["max_abs_err"], vals[4])
            if S == 4096:
                total["bound_by"] = vals[5]
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()

    vp_fwd, vp_bwd = [], []
    for (BH, S, D), vp in (((BH, S, D), vp) for (BH, S, D), _ in
                           K1_F32_SHAPES if BH in (16, 32)
                           for vp in VP_DEGREES):
        rng = np.random.default_rng(BH * S + D + vp)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       for _ in range(4))
        scale = float(D) ** -0.5
        n = S // vp
        rows_equal = dict(o=True, lse=True, dq=True)
        worst = dict(fwd=0.0, bwd=0.0)
        with torch.no_grad():
            o, lse = mha_fwd(q, k, v, scale, return_lse=True)
            dq, dk, dv = mha_bwd(q, k, v, o, do, scale, lse)
            dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
            for r in range(vp):
                rows = slice(r * n, (r + 1) * n)
                q_r, do_r = q[:, rows].contiguous(), do[:, rows].contiguous()
                o_r, lse_r = mha_fwd(q_r, k, v, scale, return_lse=True)
                ours = mha_bwd(q_r, k, v, o_r, do_r, scale, lse_r,
                               dkv_f32=True)
                worst["fwd"] = max(worst["fwd"], rel_err(
                    o_r, mha_reference(q_r, k, v, scale)))
                worst["bwd"] = max(worst["bwd"], *(
                    rel_err(a, b) for a, b in zip(ours, mha_bwd_reference(
                        q_r, k, v, o_r, do_r, scale, lse_r, dkv_f32=True))))
                rows_equal["o"] &= torch.equal(o_r, o[:, rows])
                rows_equal["lse"] &= torch.equal(lse_r, lse[:, rows])
                rows_equal["dq"] &= torch.equal(ours[0], dq[:, rows])
                dk_sum += ours[1]
                dv_sum += ours[2]
            dkv_err = max(rel_err(dk_sum, dk), rel_err(dv_sum, dv))
            if not (all(rows_equal.values()) and worst["fwd"] <= K1_F32_REL_TOL
                    and worst["bwd"] <= K1_F32_REL_TOL
                    and dkv_err <= K1_F32_REL_TOL):
                raise AssertionError(
                    f"f32 vp{vp} {BH}x{S}x{D}: rows bit-equal {rows_equal}, "
                    f"errors {worst}, dK/dV sum {dkv_err} (tol "
                    f"{K1_F32_REL_TOL})")
            q_r, do_r = q[:, :n].contiguous(), do[:, :n].contiguous()
            o_r, lse_r = mha_fwd(q_r, k, v, scale, return_lse=True)
            ms = cuda_ms(lambda: mha_fwd(q_r, k, v, scale, return_lse=True),
                         launches=K1_LAUNCHES)
            b_ms = cuda_ms(lambda: mha_bwd(q_r, k, v, o_r, do_r, scale,
                                           lse_r, dkv_f32=True),
                           launches=K1_LAUNCHES)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q_r[None], k[None], v[None], scale=scale),
                launches=K1_LAUNCHES)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q_r, k, v))
        out = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do_r[None], retain_graph=True),
            launches=K1_LAUNCHES)
        del out, qs, ks, vs
        f_bound, f_by = k1_f32_bound(BH, n, S, D)
        bw_bound, bw_by = k1b_f32_bound(BH, n, S, D)
        common = dict(shape=[BH, S, D], vp=vp, Sq=n, Sk=S)
        emit("k1_f32_vp", **common,
             plan=launch_plan(BH, n, S, D, _sms(dev), torch.float32),
             k1_max_rel_err=worst["fwd"], k1b_max_rel_err=worst["bwd"],
             tol_rel=K1_F32_REL_TOL, rows_bit_equal=rows_equal,
             dkv_sum_max_rel_err=dkv_err, k1_ms=ms, sdpa_ms=sdpa_ms,
             k1_over_library=ms / sdpa_ms, k1_bound_us=f_bound * 1e3,
             k1_bound_by=f_by, k1b_ms=b_ms, sdpa_bwd_ms=sdpa_bwd_ms,
             k1b_over_library=b_ms / sdpa_bwd_ms,
             k1b_bound_us=bw_bound * 1e3, k1b_bound_by=bw_by)
        vp_fwd.append(dict(**common, max_rel_err=worst["fwd"], ms=ms,
                           library_ms=sdpa_ms, bound_ms=f_bound,
                           rows_bit_equal=rows_equal["o"]))
        vp_bwd.append(dict(**common, max_rel_err=worst["bwd"], ms=b_ms,
                           library_ms=sdpa_bwd_ms, bound_ms=bw_bound,
                           dq_rows_bit_equal=rows_equal["dq"],
                           dkv_sum_max_rel_err=dkv_err))
        del q, k, v, do, o, lse, dq, dk, dv, dk_sum, dv_sum
        torch.cuda.empty_cache()
    emit("k1_f32_sums", **{f"{per}_{key}": val for per, d in
                           (*sums.items(), ("split_step", split))
                           for key, val in d.items()})
    return (dict(sums["forward"], shapes=shapes, vp_shapes=vp_fwd),
            dict(sums["step"], vp_shapes=vp_bwd), split)


def phase_k2_bwd(dev):
    """K2ᵇ on the bench scene (view 0, 512², 65,536 splats, R = 9 as in
    training) with a seeded cotangent, fed K2's chunk-boundary state: the
    state against the plain K2's, K2ᵇ against its plain replay, two runs
    bit for bit, the per-tile work and the blocks launched, and the time
    over K1_LAUNCHES calls and over one."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    opt = CONFIGS["big"]
    S, th, tw, dup, mpt = opt.output_size, 32, 32, 32, 1024
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g, view = bench_scene(dev)
    with torch.no_grad():
        params, counts = fs._prepare_view(g, view, S, tan, 1.0, th, tw, dup,
                                          mpt, False)
        args = (th, tw, S // tw)
        fo, state = fs.composite_fwd(params, counts, *args, return_state=True)
        _, ref_state = fs.composite_reference(params, counts, *args,
                                              return_state=True)
        torch.cuda.synchronize()
        state_err = float((state - ref_state).abs().max())
        if not state_err <= K2_ATOL:
            raise AssertionError(f"K2 state: max abs err {state_err} > "
                                 f"{K2_ATOL}")
        del ref_state
        go = torch.as_tensor(np.random.default_rng(1).normal(
            0, 1, tuple(fo.shape)), dtype=torch.float32, device=dev)
        err, rel = check_k2b(params, counts, fo, go, state, *args, "bench")

        def k2b():
            return fs.composite_bwd(params, counts, fo, go, *args,
                                    state=state)

        ms = cuda_ms(k2b, launches=K1_LAUNCHES)
        one_call_ms = cuda_ms(k2b)
        plain_ms = cuda_ms(lambda: fs.composite_bwd_reference(
            params, counts, fo, go, *args), reps=3, warm=1)
        work = fs.composite_work(params, counts, *args)
    tile_slots = work["tile_slots"].float()
    b_ms, b_by = k2b_bound(work, params.shape[2], counts, S, mpt)
    emit("k2_bwd", tiles=int(params.shape[0]), splats=65536, image=S,
         dup=dup, R=int(params.shape[2]), slots_total=int(counts.sum()),
         live_pairs=work["pairs"], used_pairs=work["used"],
         tile_slots_max=int(tile_slots.max()),
         tile_slots_mean=float(tile_slots.mean()),
         live_chunks=int(torch.ceil(tile_slots / 128).sum()),
         blocks=int(params.shape[0]) * (mpt // 128),
         balance=tile_balance(work["tile_slots"], chunked=True),
         state_mb=state.numel() * 4 / 1e6, state_max_abs_err=state_err,
         max_abs_err=err, max_row_rel_err=rel, tol_row_rel=K2B_REL_TOL,
         bitwise_repeat=True, kernel_ms=ms, kernel_one_call_ms=one_call_ms,
         was_kernel_ms=PREVIOUS_MS["k2_bwd"], plain_ms=plain_ms,
         bound_us=b_ms * 1e3, bound_by=b_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_k3(dev, ptxas):
    """K3 on the bench scene (view 0, 512², 65,536 splats, 32x32 tiles,
    K = 1024) against its plain version. Returns the kernel's row and the
    composite's inputs and output for ``phase_k3_bwd``."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.gsplat import tiled

    opt = CONFIGS["big"]
    S, th, tw, K = opt.output_size, 32, 32, 1024
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g, view = bench_scene(dev)
    with torch.inference_mode():
        args = tiled._prepare_view(g, view, S, tan, 1.0, th, tw, K)
        fo, err = check_k3(*args, "bench")
        ms = cuda_ms(lambda: tiled.tile_composite_fwd(*args),
                     launches=K1_LAUNCHES)
        one_call_ms = cuda_ms(lambda: tiled.tile_composite_fwd(*args))
        plain_ms = cuda_ms(lambda: tiled.tile_composite_reference(*args),
                           reps=5)
        work = tiled.tile_composite_work(*args)
    params, counts, pf = args
    b_ms, b_by = k3_bound(work, counts.numel(), pf.shape[0])
    emit("k3", tiles=int(params.shape[0]), splats=int(g.shape[0]), image=S,
         max_per_tile=K, slots_total=int(counts.sum()),
         live_chunks=work["chunks"], live_pairs=work["pairs"],
         used_pairs=work["used"],
         balance=tile_balance(torch.minimum(work["tile_chunks"] * 128,
                                            counts.long()), chunked=False),
         **launch_info("tiled_fwd", tiled.K3_VARIANT, pf.shape[0], ptxas),
         max_abs_err=err, tol=K3_ATOL, kernel_ms=ms,
         kernel_one_call_ms=one_call_ms,
         was_kernel_one_call_ms=PREVIOUS_MS["k3"], plain_ms=plain_ms,
         bound_us=b_ms * 1e3, bound_by=b_by)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), args, fo, work


def phase_k3_bwd(dev, args, fo, work):
    """K3ᵇ on the bench scene's composite with a seeded cotangent, fed K3's
    chunk-boundary state: the state against the plain K3's, K3ᵇ against
    its plain replay, two runs bit for bit, the per-tile work and the
    blocks launched, and the time over K1_LAUNCHES calls and over one."""
    import numpy as np
    import torch

    from lgm_tpu_torch.ops.gsplat import tiled

    params, counts, pf = args
    with torch.no_grad():
        fo2, state = tiled.tile_composite_fwd(*args, return_state=True)
        _, ref_state = tiled.tile_composite_reference(*args,
                                                      return_state=True)
        torch.cuda.synchronize()
        if not torch.equal(fo2, fo):
            raise AssertionError("K3 with its state differs from K3 without")
        state_err = float((state - ref_state).abs().max())
        if not state_err <= K3_ATOL:
            raise AssertionError(f"K3 state: max abs err {state_err} > "
                                 f"{K3_ATOL}")
        del fo2, ref_state
        go = torch.as_tensor(np.random.default_rng(1).normal(
            0, 1, tuple(fo.shape)), dtype=torch.float32, device=dev)
        err, rel = check_k3b(*args, fo, go, state, "bench")

        def k3b():
            return tiled.tile_composite_bwd(*args, fo, go, state)

        ms = cuda_ms(k3b, launches=K1_LAUNCHES)
        one_call_ms = cuda_ms(k3b)
        plain_ms = cuda_ms(lambda: tiled.tile_composite_bwd_reference(
            *args, fo, go), reps=3, warm=1)
    chunks = work["tile_chunks"]
    b_ms, b_by = k3b_bound(work, counts.numel(), pf.shape[0],
                           params.shape[2])
    emit("k3_bwd", tiles=int(params.shape[0]), splats=65536,
         max_per_tile=int(params.shape[2]), slots_total=int(counts.sum()),
         live_chunks=work["chunks"], live_pairs=work["pairs"],
         used_pairs=work["used"], tile_chunks_max=int(chunks.max()),
         tile_chunks_mean=float(chunks.float().mean()),
         blocks=int(params.shape[0]) * (int(params.shape[2]) // 128),
         balance=tile_balance(torch.minimum(chunks * 128, counts.long()),
                              chunked=True),
         state_mb=state.numel() * 4 / 1e6, state_max_abs_err=state_err,
         max_abs_err=err, max_row_rel_err=rel, tol_row_rel=K3B_REL_TOL,
         bitwise_repeat=True, kernel_ms=ms, kernel_one_call_ms=one_call_ms,
         was_kernel_ms=PREVIOUS_MS["k3_bwd"], plain_ms=plain_ms,
         bound_us=b_ms * 1e3, bound_by=b_by)
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
    k1_before = k1_route_launches()
    with route_counts() as routes, process_clock() as clock:
        res = infer.process(opt, mv, os.path.join(work, "big"),
                            device=str(dev), model=model)
    k1_routes = check_k1_routes("main", k1_before, k1_site_dims(model),
                                {"mha_fwd": 1})
    launches = {"mha_fwd": mha_fwd.launches,
                "composite_fwd": fs.composite_fwd.launches}
    # K1 at every attention site of the forward (bf16: the gate's kernel
    # route at all of them), K2 once an orbit frame.
    sites = sum(isinstance(m, unet_mod.MVAttention) for m in model.modules())
    expected = {"mha_fwd": sites, "composite_fwd": 180}
    if launches != expected or routes != {"kernel": sites, "dense": 0}:
        raise AssertionError(f"launches {launches}, expected {expected}; "
                             f"attention routes {routes}")

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
        k2_err = float((fs.composite_fwd(*args)
                        - fs.composite_reference(*args)).abs().max())
        if not k2_err <= K2_ATOL:
            raise AssertionError(f"K2 frame 0: max abs err {k2_err}")
        k2_ms = cuda_ms(lambda: fs.composite_fwd(*args), launches=K1_LAUNCHES)
        k2_one_call_ms = cuda_ms(lambda: fs.composite_fwd(*args))
        k2_plain_ms = cuda_ms(lambda: fs.composite_reference(*args), reps=5)
        k2_work = fs.composite_work(*args)
    emit("k2_main_frame0", slots_total=int(counts.sum()),
         live_pairs=k2_work["pairs"], used_pairs=k2_work["used"],
         tile_slots_max=int(k2_work["tile_slots"].max()),
         balance=tile_balance(k2_work["tile_slots"], chunked=False),
         max_abs_err=k2_err, kernel_ms=k2_ms,
         kernel_one_call_ms=k2_one_call_ms, plain_ms=k2_plain_ms,
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
        forward_s=clock["forward_s"], forward_warm_s=sorted(warm)[1],
        orbit_s=clock["orbit_s"], orbit_fps=180 / clock["orbit_s"],
        launches=launches, attention_routes=routes, **k1_routes,
        frame0_vs_plain_max=frame_err,
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
    state, data and step functions: one cold step, three warm ones, with
    all four kernels counted; then K1ᵇ and K2ᵇ against their plain
    versions on that run's own inputs (the cold step's deepest attention
    site, and the last backward composite, view 0); then two steps in the
    CLI's default configuration (U-Net recompute on), timed with and
    without the batch's rendering; then a profile of one warm step."""
    import torch

    from lgm_tpu_torch import train
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.models.unet import MVAttention
    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.gsplat import projection as pj

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

    captured = {}
    counters = (mha_mod.mha_fwd, mha_mod.mha_bwd, fs.composite_fwd,
                fs.composite_bwd, pj.project_fwd, pj.project_bwd)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    k1_before = k1_route_launches()
    step_s, data_s, losses, gnorms = timed_steps(
        state, train_ds, gen, dev, range(N_STEPS),
        spies=backward_spies(captured))
    launches = {fn.__name__: fn.launches for fn in counters}
    dims = k1_site_dims(state.model)
    k1_routes = check_k1_routes("train", k1_before, dims,
                                {"mha_fwd": N_STEPS, "mha_bwd": N_STEPS})
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    # Per step: K1 and K1ᵇ at every attention site (16), K2 (with its
    # state) and K2ᵇ on every supervision view (16); per batch: K2 on those
    # views' ground truth at 512² and on the input views at 256² (24). The
    # projection kernels once a view wherever K2 and K2ᵇ run.
    sites = sum(isinstance(m, MVAttention) for m in state.model.modules())
    views = opt.batch_size * opt.num_views
    inputs = (opt.batch_size * opt.num_input_views
              if opt.input_size != opt.output_size else 0)
    expected = {"mha_fwd": sites * N_STEPS, "mha_bwd": sites * N_STEPS,
                "composite_fwd": (2 * views + inputs) * N_STEPS,
                "composite_bwd": views * N_STEPS,
                "project_fwd": (2 * views + inputs) * N_STEPS,
                "project_bwd": views * N_STEPS}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    warm = median(step_s[1:])
    loop_warm = median([d + s for d, s in zip(data_s[1:], step_s[1:])])
    emit("train", preset="big", batch_size=2, params=n_params,
         setup_s=setup_s, step_s=step_s[0], step_warm_s=warm,
         steps_s=step_s, data_s=data_s, train_steps_per_s=1.0 / warm,
         loop_steps_per_s=1.0 / loop_warm,
         loss=losses, gnorm=gnorms, lr=[train.current_lr(opt, i)
                                        for i in range(N_STEPS)],
         peak_mem_gb=peak_gb, launches=launches, **k1_routes)

    # The kernels on the step's own inputs (launches here are not counted
    # above: the counts were read already).
    q, k, v, o, do, scale, lse = captured["k1"]
    with torch.no_grad():
        # K1 on the site's own inputs; what it gives again is what the
        # step saved (the kernel is deterministic).
        k1f_route, (o2, lse2, k1f_err, _, k1f_lse_err, _) = route_of(
            mha_mod.mha_fwd, lambda: check_k1(q, k, v, scale, "train step"))
        if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
            raise AssertionError("K1 on the step's inputs differs from the "
                                 "step's own o or lse")
        del o2, lse2
        k1_route, (k1_err, k1_tol) = route_of(
            mha_mod.mha_bwd,
            lambda: check_k1b(q, k, v, o, do, scale, lse, "train step"))
        k1_ms = cuda_ms(lambda: mha_mod.mha_bwd(q, k, v, o, do, scale, lse),
                        launches=K1_LAUNCHES)
        params, counts, fo, go, k2_state, th, tw, tiles_x = captured["k2"]
        k2_err, k2_rel = check_k2b(params, counts, fo, go, k2_state, th, tw,
                                   tiles_x, "train step")

        def k2b():
            return fs.composite_bwd(params, counts, fo, go, th, tw, tiles_x,
                                    state=k2_state)

        k2_ms = cuda_ms(k2b, launches=K1_LAUNCHES)
        k2_one_call_ms = cuda_ms(k2b)
        # K2 as the step ran it on this view (writing its state), against
        # its plain version.
        out, k2f_state = fs.composite_fwd(params, counts, th, tw, tiles_x,
                                          return_state=True)
        if not (torch.equal(out, fo) and torch.equal(k2f_state, k2_state)):
            raise AssertionError("K2 on the step's view differs from the "
                                 "step's own output or state")
        k2f_err = float((out - fs.composite_reference(
            params, counts, th, tw, tiles_x)).abs().max())
        if not k2f_err <= K2_ATOL:
            raise AssertionError(f"K2 train step: max abs err {k2f_err}")
        k2f_ms = cuda_ms(lambda: fs.composite_fwd(
            params, counts, th, tw, tiles_x, return_state=True),
            launches=K1_LAUNCHES)
        del out, k2f_state
        work = fs.composite_work(params, counts, th, tw, tiles_x)
        # Each supervision view's tile balance (the order autograd ran
        # them in).
        balance = [tile_balance(fs.composite_work(*v)["tile_slots"],
                                chunked=True) for v in captured["views"]]
    emit("train_kernels", k1_route=k1f_route, k1_max_abs_err=k1f_err,
         k1_lse_max_abs_err=k1f_lse_err, k1_bwd_route=k1_route,
         k1_bwd_shape=list(q.shape), k1_bwd_max_abs_err=k1_err,
         k1_bwd_tol=k1_tol, k1_bwd_ms=k1_ms, k2_max_abs_err=k2f_err,
         k2_with_state_ms=k2f_ms,
         k2_bound_us=k2_bound(work, params.shape[2], counts,
                              tw * tiles_x)[0] * 1e3,
         k2_bwd_slots_total=int(counts.sum()), k2_bwd_live_pairs=work["pairs"],
         k2_bwd_used_pairs=work["used"], k2_bwd_max_abs_err=k2_err,
         k2_bwd_max_row_rel_err=k2_rel, k2_bwd_bitwise_repeat=True,
         k2_bwd_ms=k2_ms, k2_bwd_one_call_ms=k2_one_call_ms,
         k2_bwd_bound_us=k2b_bound(work, params.shape[2], counts,
                                   tw * tiles_x, params.shape[1])[0] * 1e3,
         k2_state_mb_per_view=k2_state.numel() * 4 / 1e6,
         views=len(balance),
         tiles_over_even=[b["tiles_over_even"] for b in balance],
         chunks_over_even=[b["chunks_over_even"] for b in balance])
    captured.clear()
    del q, k, v, o, do, lse, params, counts, fo, go, k2_state

    # The configuration `python -m lgm_tpu_torch.train big` runs by
    # default: the preset's U-Net recompute on (the same state, the flag
    # read at each forward), batch rendering in the loop as in train.main.
    unet = state.model.lgm.unet
    unet.remat = True
    torch.cuda.reset_peak_memory_stats(dev)
    k1_before = k1_route_launches()
    remat_s, remat_data_s, _, _ = timed_steps(
        state, train_ds, gen, dev, range(N_STEPS, N_STEPS + 2))
    remat_loop_s = [d + s for d, s in zip(remat_data_s, remat_s)]
    unet.remat = False
    # K1 twice a site a step (the forward and the recompute), K1ᵇ once.
    k1_routes = check_k1_routes("train_cli_default", k1_before, dims,
                                {"mha_fwd": 4, "mha_bwd": 2})
    emit("train_cli_default", unet_remat=True, steps_s=remat_s, **k1_routes,
         step_warm_s=median(remat_s[1:]),
         train_steps_per_s=1.0 / median(remat_s[1:]),
         loop_s=remat_loop_s, loop_steps_per_s=1.0 / median(remat_loop_s[1:]),
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)

    data = train._batch_data(train_ds.batch(N_STEPS + 2))
    bg = torch.rand(3, generator=gen).to(dev)
    profile_window("train_step", lambda: train.train_step(state, data, bg))
    return launches


def backward_spies(captured: dict):
    """Mock patches of the two autograd Functions' backward (not of the
    counted wrappers) that keep a step's own K1ᵇ and K2ᵇ inputs in
    ``captured``: ``k1``, the deepest attention site's (q, k, v, o, do,
    scale, lse); ``k2``, the last composite backward's (view 0) params,
    counts, output, grad, K2's state and tiling; ``views``, every
    composite backward's (params, counts, tiling). Each reads
    ``ctx.saved_tensors`` once (the U-Net recompute allows one unpack)
    and hands the original backward a stand-in holding them."""
    from types import SimpleNamespace
    from unittest import mock

    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    orig_mha_back = mha_mod._MHA.backward
    orig_comp_back = fs._Composite.backward

    def spy_mha_back(ctx, do):
        saved = ctx.saved_tensors
        q, k, v, o, lse = saved
        if q.shape[1] >= captured.get("k1_S", 0):
            captured.update(k1=(q, k, v, o, do.contiguous(), ctx.scale, lse),
                            k1_S=q.shape[1])
        return orig_mha_back(SimpleNamespace(saved_tensors=saved,
                                             scale=ctx.scale), do)

    def spy_comp_back(ctx, go):
        saved = ctx.saved_tensors
        params, counts, out, k2_state = saved
        captured["k2"] = (params, counts, out, go.contiguous(),
                          k2_state) + ctx.tiling
        captured.setdefault("views", []).append((params, counts)
                                                + ctx.tiling)
        return orig_comp_back(SimpleNamespace(saved_tensors=saved,
                                              tiling=ctx.tiling), go)

    return (mock.patch.object(mha_mod._MHA, "backward",
                              staticmethod(spy_mha_back)),
            mock.patch.object(fs._Composite, "backward",
                              staticmethod(spy_comp_back)))


def timed_steps(state, train_ds, gen, dev, steps, spies=()):
    """``train.train_step`` on the dataset's batches ``steps``: each batch
    is made, and timed apart, before its step's clock starts; each step
    ends in a synchronize; the first runs under the ``spies`` (mock
    patches). Returns the steps' seconds, the batches' seconds, the losses
    and the gradient norms, and raises if one is not finite."""
    import contextlib

    import numpy as np
    import torch

    from lgm_tpu_torch import train

    step_s, data_s, losses, gnorms = [], [], [], []
    for n, i in enumerate(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = train._batch_data(train_ds.batch(i))
        bg = torch.rand(3, generator=gen).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for spy in spies if n == 0 else ():
                stack.enter_context(spy)
            m = train.train_step(state, data, bg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        data_s.append(t1 - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    if not np.isfinite(losses).all() or not np.isfinite(gnorms).all():
        raise AssertionError(f"non-finite loss or gnorm: {losses} {gnorms}")
    return step_s, data_s, losses, gnorms


def phase_train_v1(dev):
    """LGM big training at batch 2 with ``rasterizer="pallas_v1"``: the
    supervision views go through the v1 tiled rasterizer. One cold and
    three warm steps through the trainer's own state, data and step
    functions with all six kernels counted; then K3 and K3ᵇ against their
    plain versions on the cold step's own inputs (the last composite
    backward, view 0); then a profile of one warm step."""
    from unittest import mock

    import torch

    from lgm_tpu_torch import train
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.models.unet import MVAttention
    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.gsplat import tiled

    opt = CONFIGS["big"].replace(batch_size=2, unet_remat=False,
                                 rasterizer="pallas_v1")
    state = train.create_state(opt, dev)
    train_ds, _ = train.make_datasets(opt, dev)
    gen = torch.Generator().manual_seed(42)

    captured = {}
    orig_back = tiled._TileComposite.backward

    def spy_back(ctx, go):
        captured["k3"] = tuple(ctx.saved_tensors) + (go.contiguous(),)
        captured.setdefault("views", []).append(ctx.saved_tensors[:3])
        return orig_back(ctx, go)

    counters = (mha_mod.mha_fwd, mha_mod.mha_bwd, fs.composite_fwd,
                fs.composite_bwd, tiled.tile_composite_fwd,
                tiled.tile_composite_bwd)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_s, data_s, losses, gnorms = timed_steps(
        state, train_ds, gen, dev, range(N_STEPS), spies=(
            mock.patch.object(tiled._TileComposite, "backward",
                              staticmethod(spy_back)),))
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    # Per step: K1 and K1ᵇ at every attention site (16), K3 and K3ᵇ on
    # every supervision view (16); per batch: K2 on those views' ground
    # truth at 512² and on the input views at 256² (24). K2ᵇ has no place
    # on this path.
    sites = sum(isinstance(m, MVAttention) for m in state.model.modules())
    views = opt.batch_size * opt.num_views
    inputs = (opt.batch_size * opt.num_input_views
              if opt.input_size != opt.output_size else 0)
    expected = {"mha_fwd": sites * N_STEPS, "mha_bwd": sites * N_STEPS,
                "composite_fwd": (views + inputs) * N_STEPS,
                "composite_bwd": 0, "tile_composite_fwd": views * N_STEPS,
                "tile_composite_bwd": views * N_STEPS}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    warm = median(step_s[1:])
    emit("train_v1", preset="big", batch_size=2, rasterizer="pallas_v1",
         step_s=step_s[0], step_warm_s=warm, steps_s=step_s, data_s=data_s,
         train_steps_per_s=1.0 / warm, loop_steps_per_s=1.0 / median(
             [d + s for d, s in zip(data_s[1:], step_s[1:])]),
         loss=losses, gnorm=gnorms, peak_mem_gb=peak_gb, launches=launches)

    # The kernels on the step's own inputs (launches here are not counted
    # above: the counts were read already).
    params, counts, pf, fo, k3_state, go = captured["k3"]
    with torch.no_grad():
        k3_out, k3_err = check_k3(params, counts, pf, "train step")
        if not torch.equal(k3_out, fo):
            raise AssertionError("K3 on the step's view differs from the "
                                 "step's own output")
        k3_ms = cuda_ms(lambda: tiled.tile_composite_fwd(params, counts, pf),
                        launches=K1_LAUNCHES)
        k3_one_call_ms = cuda_ms(lambda: tiled.tile_composite_fwd(
            params, counts, pf))
        k3b_err, k3b_rel = check_k3b(params, counts, pf, fo, go, k3_state,
                                     "train step")

        def k3b():
            return tiled.tile_composite_bwd(params, counts, pf, fo, go,
                                            k3_state)

        k3b_ms = cuda_ms(k3b, launches=K1_LAUNCHES)
        k3b_one_call_ms = cuda_ms(k3b)
        work = tiled.tile_composite_work(params, counts, pf)
        # Each supervision view's tile balance: the slots K3ᵇ visits a
        # tile (its live chunks, up to its count).
        balance = []
        for p_, c_, f_ in captured["views"]:
            chunks = tiled.tile_composite_work(p_, c_, f_)["tile_chunks"]
            balance.append(tile_balance(
                torch.minimum(chunks * 128, c_.long()), chunked=True))
    T, P, K = counts.numel(), pf.shape[0], params.shape[2]
    emit("train_v1_kernels", slots_total=int(counts.sum()),
         live_chunks=work["chunks"], live_pairs=work["pairs"],
         used_pairs=work["used"], k3_max_abs_err=k3_err, k3_ms=k3_ms,
         k3_one_call_ms=k3_one_call_ms,
         k3_bound_us=k3_bound(work, T, P)[0] * 1e3,
         k3_bwd_max_abs_err=k3b_err, k3_bwd_max_row_rel_err=k3b_rel,
         k3_bwd_bitwise_repeat=True, k3_bwd_ms=k3b_ms,
         k3_bwd_one_call_ms=k3b_one_call_ms,
         k3_bwd_bound_us=k3b_bound(work, T, P, K)[0] * 1e3,
         k3_state_mb_per_view=k3_state.numel() * 4 / 1e6,
         views=len(balance),
         tiles_over_even=[b["tiles_over_even"] for b in balance],
         chunks_over_even=[b["chunks_over_even"] for b in balance])
    captured.clear()
    del params, counts, pf, fo, go, k3_state

    data = train._batch_data(train_ds.batch(N_STEPS))
    bg = torch.rand(3, generator=gen).to(dev)
    profile_window("train_v1_step",
                   lambda: train.train_step(state, data, bg))
    return launches


def phase_v1_image(dev):
    """The ``pallas_v1`` backend's image of the bench scene at 128² held
    to the exact oracle, and beside flatsort's. Held: with the per-tile
    cap out of play (max_per_tile >= N), the mean abs difference to the
    oracle is at most 1e-3, the bound the CPU tests put on every pixel of
    their small scenes. The max is reported and not held: the expanded
    quadratic can round a splat's power above 0 at a pixel on its centre,
    which drops it there (a property of the function, lgm_tpu's too), and
    among 65,536 splats a few pixels meet that. At the default cap
    (K = 1024 nearest splats of a 32x32 tile) the differences are
    reported only: the cap truncates a scene this dense at 128²."""
    import numpy as np
    import torch

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.gsplat.api import render_views

    tan = float(np.tan(0.5 * np.deg2rad(CONFIGS["big"].fovy)))
    g, view = bench_scene(dev)

    def image(backend, **kw):
        with torch.inference_mode():
            return render_views(g[None], view[None, None], 128, tan,
                                backend=backend, **kw)["image"][0, 0]

    oracle = image("reference")
    n_cap = -(-g.shape[0] // 128) * 128   # N up to a whole chunk
    uncapped = (image("pallas_v1", max_per_tile=n_cap) - oracle).abs()
    capped = image("pallas_v1")
    vs_oracle = (capped - oracle).abs()
    vs_flatsort = (capped - image("flatsort", dup=32)).abs()
    torch.cuda.synchronize()
    mean = float(uncapped.mean())
    emit("v1_image", image=128, splats=g.shape[0],
         uncapped_vs_reference_mean=mean, tol_mean=1e-3,
         uncapped_vs_reference_max=float(uncapped.max()),
         uncapped_pixels_over_1e_3=int((uncapped.amax(dim=-1) > 1e-3).sum()),
         vs_reference_max=float(vs_oracle.max()),
         vs_reference_mean=float(vs_oracle.mean()),
         vs_flatsort_max=float(vs_flatsort.max()),
         vs_flatsort_mean=float(vs_flatsort.mean()))
    if not mean <= 1e-3:
        raise AssertionError(f"pallas_v1 vs the oracle: mean abs {mean}")


def route_counts(unet_mod=None):
    """A context in which the attention gate's two routes are counted:
    yields {"kernel": calls of mha, "dense": calls of dense_attention},
    filled in as the model runs (in ``models/unet.py``, or in the module
    ``unet_mod`` given: ``diffusion/mv_unet.py``)."""
    import contextlib
    from unittest import mock

    if unet_mod is None:
        import lgm_tpu_torch.models.unet as unet_mod

    @contextlib.contextmanager
    def counting():
        counts = {"kernel": 0, "dense": 0}

        def spy(route, fn):
            def call(*args):
                counts[route] += 1
                return fn(*args)
            return call

        with mock.patch.object(unet_mod, "mha", spy("kernel", unet_mod.mha)), \
                mock.patch.object(unet_mod, "dense_attention",
                                  spy("dense", unet_mod.dense_attention)):
            yield counts

    return counting()


def phase_nano(dev):
    """The attention gate on the card: the ``nano`` preset (head dim 96/16
    = 6, which K1 does not take) trained one step in fp32 and in bf16
    through ``train.create_state``/``train_step`` on a synthetic batch;
    every attention call takes the dense route, and the loss is finite."""
    import numpy as np
    import torch

    from lgm_tpu_torch import train
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import make_batch
    from lgm_tpu_torch.models.unet import MVAttention

    out = {}
    for precision in ("fp32", "bf16"):
        opt = CONFIGS["nano"].replace(mixed_precision=precision)
        state = train.create_state(opt, dev)
        batch = make_batch(np.random.default_rng(1), opt, device=dev)
        data = train._batch_data(batch)
        with route_counts() as routes:
            m = train.train_step(state, data, torch.ones(3, device=dev))
        torch.cuda.synchronize()
        loss = float(m["loss"])
        sites = sum(isinstance(x, MVAttention) for x in state.model.modules())
        if not (np.isfinite(loss) and routes["kernel"] == 0
                and routes["dense"] >= sites > 0):
            raise AssertionError(f"nano {precision}: loss {loss}, attention "
                                 f"routes {routes} over {sites} sites")
        out[precision] = dict(loss=loss, gnorm=float(m["gnorm"]),
                              attention_sites=sites, attention_routes=routes)
    emit("nano_precisions", **out)


def phase_fp32(dev, mv):
    """LGM big at ``mixed_precision="fp32"``, the whole net in f32 and every
    attention site on the f32 kernels: ``infer.process`` on phase
    ``main``'s four views (f32 K1 16 a forward, K2 180, no bf16 K1, no
    dense site), its warm forward and orbit, and the Gaussians against the
    same forward with the plain version in place of the f32 K1; then
    ``train.train_step`` at bs2 without the U-Net recompute, on the kernel
    route (f32 K1 and K1ᵇ 16 each a step) and then, from the same seeded
    weights, batches and backgrounds, on the dense route, forced in this
    process by replacing the gate's ``kernel_takes`` (every site through
    ``dense_attention``): step times, peak memory, and the two routes'
    first losses held to each other (FP32_ROUTE_LOSS_RTOL); then one step
    at the preset's own batch of 8 with its ``unet_remat`` on the kernel
    route (f32 K1 32, K1ᵇ 16), its peak memory, and the dense route's bs 8
    peak reckoned from the bs2 measurements (not run). Every f32 K1 and
    K1ᵇ launch runs the split pass first (``mha_split_tf32``: 16 a
    forward, 32 a bs2 step, 48 a bs 8 step). One warm fp32 forward and
    one bs2 step on the kernel route are profiled (``fp32_forward``,
    ``fp32_train_step``)."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    import lgm_tpu_torch.models.unet as unet_mod
    from lgm_tpu_torch import infer, train
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    counters = (mha_mod.mha_fwd, mha_mod.mha_bwd, mha_mod.mha_fwd_f32,
                mha_mod.mha_bwd_f32, mha_mod.mha_split_tf32,
                fs.composite_fwd, fs.composite_bwd)

    def reset():
        for fn in counters:
            fn.launches = 0

    def read():
        return {fn.__name__: fn.launches for fn in counters}

    def gb():  # GiB, as every phase's peak_mem_gb
        return torch.cuda.max_memory_allocated(dev) / 2**30

    opt = CONFIGS["big"].replace(mixed_precision="fp32")
    model = infer.load_model(opt, device=str(dev))
    sites = sum(isinstance(m, unet_mod.MVAttention) for m in model.modules())
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    torch.cuda.reset_peak_memory_stats(dev)
    reset()
    with route_counts() as routes, process_clock() as clock:
        res = infer.process(opt, mv, os.path.join(work, "big_fp32"),
                            device=str(dev), model=model)
    launches = read()
    infer_peak = gb()
    expected = dict.fromkeys(launches, 0)
    expected.update(mha_fwd_f32=sites, mha_split_tf32=sites,
                    composite_fwd=180)
    gs = res["gaussians"]
    n = 4 * opt.splat_size ** 2
    if (launches != expected or routes != {"kernel": sites, "dense": 0}
            or gs.shape != (1, n, 14) or not np.isfinite(gs).all()):
        raise AssertionError(
            f"fp32 infer: launches {launches}, expected {expected}; routes "
            f"{routes}; gaussians {gs.shape}, finite {np.isfinite(gs).all()}")
    # The forward with the f32 plain version in place of the f32 K1.
    with mock.patch.object(unet_mod, "mha", mha_mod.mha_reference):
        gs_plain = infer.forward_gaussians(model, mv)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer.forward_gaussians(model, mv)
        warm.append(time.perf_counter() - t0)
    emit("fp32_infer", preset="big", mixed_precision="fp32",
         forward_s=clock["forward_s"], forward_warm_s=sorted(warm)[1],
         orbit_s=clock["orbit_s"], launches=launches, attention_routes=routes,
         gaussians_vs_plain_attention_max=float(np.abs(gs - gs_plain).max()),
         peak_mem_gb=infer_peak)
    profile_window("fp32_forward",
                   lambda: infer.forward_gaussians(model, mv))
    del model, res, gs, gs_plain
    torch.cuda.empty_cache()

    def run(opt, steps, dense=False, profile=None):
        """``steps`` train steps from the seeded weights, on the kernel
        route or (``dense``) with the gate forced dense; returns the
        steps' seconds, losses, gradient norms, launches, routes and peak
        memory. With ``profile``, one more step is then profiled under
        that window name (after the counts and the peak are read)."""
        state = train.create_state(opt, dev)
        train_ds, _ = train.make_datasets(opt, dev)
        gen = torch.Generator().manual_seed(42)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        with contextlib.ExitStack() as stack:
            if dense:
                stack.enter_context(mock.patch.object(
                    unet_mod, "kernel_takes", lambda *a: False))
            routes = stack.enter_context(route_counts())
            step_s, _, losses, gnorms = timed_steps(state, train_ds, gen,
                                                    dev, range(steps))
        out = dict(steps_s=step_s, loss=losses, gnorm=gnorms,
                   launches=read(), attention_routes=routes,
                   peak_mem_gb=gb())
        views = opt.batch_size * opt.num_views
        inputs = (opt.batch_size * opt.num_input_views
                  if opt.input_size != opt.output_size else 0)
        calls = (2 if opt.unet_remat else 1) * sites * steps
        expected = dict.fromkeys(out["launches"], 0)
        expected.update(composite_fwd=(2 * views + inputs) * steps,
                        composite_bwd=views * steps)
        if not dense:
            expected.update(mha_fwd_f32=calls, mha_bwd_f32=sites * steps,
                            mha_split_tf32=calls + sites * steps)
        want_routes = {"kernel": 0 if dense else calls,
                       "dense": calls if dense else 0}
        if out["launches"] != expected or routes != want_routes:
            route = "dense" if dense else "kernel"
            raise AssertionError(
                f"fp32 train bs{opt.batch_size} ({route} route): launches "
                f"{out['launches']}, expected {expected}; routes {routes}, "
                f"expected {want_routes}")
        if profile:
            data = train._batch_data(train_ds.batch(steps))
            bg = torch.rand(3, generator=gen).to(dev)
            profile_window(profile,
                           lambda: train.train_step(state, data, bg))
        del state, train_ds
        torch.cuda.empty_cache()
        return out

    bs2 = CONFIGS["big"].replace(batch_size=2, unet_remat=False,
                                 mixed_precision="fp32")
    kernel = run(bs2, N_FP32_STEPS, profile="fp32_train_step")
    dense = run(bs2, N_FP32_STEPS, dense=True)
    loss_diff = abs(kernel["loss"][0] - dense["loss"][0])
    if not loss_diff <= FP32_ROUTE_LOSS_RTOL * abs(dense["loss"][0]):
        raise AssertionError(f"fp32 bs2 loss, kernel route "
                             f"{kernel['loss'][0]} vs dense "
                             f"{dense['loss'][0]}")
    for row in (kernel, dense):
        row["step_warm_s"] = median(row["steps_s"][1:])
    emit("fp32_train", preset="big", batch_size=2, unet_remat=False,
         kernel=kernel, dense=dense, first_loss_rel_diff=loss_diff
         / abs(dense["loss"][0]), loss_rtol=FP32_ROUTE_LOSS_RTOL,
         first_gnorm_rel_diff=abs(kernel["gnorm"][0] - dense["gnorm"][0])
         / abs(dense["gnorm"][0]),
         peak_saved_gb=dense["peak_mem_gb"] - kernel["peak_mem_gb"],
         step_warm_over_dense=kernel["step_warm_s"] / dense["step_warm_s"])
    bs8 = CONFIGS["big"].replace(mixed_precision="fp32")
    big8 = run(bs8, 1)
    # The dense route's extra memory is the attention's O(BH S²) buffers,
    # BH = 16 a scene: at bs 8 four times the bs2 extra (both without the
    # recompute; with it, only one block's sites are live at a time).
    extra2 = dense["peak_mem_gb"] - kernel["peak_mem_gb"]
    emit("fp32_train_bs8", preset="big", batch_size=bs8.batch_size,
         unet_remat=bs8.unet_remat, step_s=big8["steps_s"][0],
         loss=big8["loss"][0], gnorm=big8["gnorm"][0],
         launches=big8["launches"], attention_routes=big8["attention_routes"],
         peak_mem_gb=big8["peak_mem_gb"],
         dense_extra_bs2_gb=extra2,
         dense_peak_reckoned_gb=big8["peak_mem_gb"]
         + extra2 * bs8.batch_size / bs2.batch_size,
         card_gb=torch.cuda.get_device_properties(dev).total_memory / 2**30)
    return dict(infer=launches, train=kernel["launches"],
                train_bs8=big8["launches"])


def phase_bridge(dev):
    """The committed nano checkpoint converted from lgm_tpu's (``bridge``):
    read by ``infer.load_model`` (``infer --resume``) and by
    ``train.load_checkpoint`` (``train --resume``) in f32, TF32 off; the
    Gaussians of the committed input within ``BRIDGE_GAUSSIANS_ATOL`` of
    lgm_tpu's, the next step's loss terms and gradient norm (committed
    batch and background, the exact renderer as lgm_tpu's ``xla``) within
    ``BRIDGE_LOSS_RTOL``; then ``train.main`` resumed from the file takes
    step 2 on its own synthetic batch (flatsort) and saves ``ckpt_2``."""
    import shutil

    import numpy as np
    import torch

    from lgm_tpu_torch import infer, train
    from lgm_tpu_torch.config import parse_cli

    ckpt = os.path.join(BRIDGE_DIR, "ckpt_1")
    ref = np.load(os.path.join(BRIDGE_DIR, "reference.npz"))
    opt = parse_cli(BRIDGE_FLAGS)
    keys = ("input", "images_output", "masks_output", "cam_view")
    data = {k: torch.as_tensor(ref[k], device=dev) for k in keys}
    model = infer.load_model(opt, ckpt, str(dev))
    with torch.no_grad():
        g = model(data["input"]).cpu().numpy()
    del model
    g_err = float(np.abs(g - ref["gaussians"]).max())
    state = train.load_checkpoint(ckpt, train.create_state(
        opt, dev, backend="reference"))
    if state.step != 1 or state.optimizer.mu[0].dtype != torch.bfloat16:
        raise AssertionError(f"bridge: resumed at step {state.step}, mu "
                             f"{state.optimizer.mu[0].dtype}")
    m = train.train_step(state, data, torch.as_tensor(ref["bg"],
                                                      device=dev))
    torch.cuda.synchronize()
    rel = {k: abs(float(m[k]) - float(ref[k])) / abs(float(ref[k]))
           for k in ("loss", "loss_mse", "psnr", "gnorm")}
    del state
    if g_err > BRIDGE_GAUSSIANS_ATOL or max(rel.values()) > BRIDGE_LOSS_RTOL:
        raise AssertionError(f"bridge: Gaussians max abs err {g_err}, "
                             f"loss terms rel err {rel}")
    ws = os.path.join(ROOT, "build", "smoke", "bridge")
    shutil.rmtree(ws, ignore_errors=True)
    t0 = time.perf_counter()
    train.main([*BRIDGE_FLAGS, "--workspace", ws, "--resume", ckpt,
                "--total-steps", "2", "--device", dev.type])
    cli_s = time.perf_counter() - t0
    resumed = torch.load(os.path.join(ws, "ckpt_2"), map_location="cpu",
                         weights_only=True)
    if resumed["step"] != 2 or resumed["opt_state"]["count"] != 2:
        raise AssertionError(f"bridge: train --resume wrote step "
                             f"{resumed['step']}")
    shutil.rmtree(ws, ignore_errors=True)
    torch.cuda.empty_cache()
    emit("bridge", checkpoint=os.path.relpath(ckpt, ROOT),
         checkpoint_bytes=os.path.getsize(ckpt),
         gaussians_max_abs_err=g_err, gaussians_atol=BRIDGE_GAUSSIANS_ATOL,
         loss_rel_err=rel, loss_rtol=BRIDGE_LOSS_RTOL,
         loss=float(m["loss"]), lgm_tpu_loss=float(ref["loss"]),
         train_resume_s=cli_s, train_resume_step=2)


def phase_k1_diffusion(dev):
    """K1 at the diffusion U-Net's level-0 joint self-attention
    (``K1_DIFFUSION_SHAPES``) against its plain version, run twice for the
    same bits, its device time over K1_LAUNCHES calls beside SDPA's
    forward and the bound. Returns the kernels-line entries by model."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import (_sms, launch_plan, mha_fwd,
                                       mha_reference)

    out = {}
    for model, (BH, S, D) in K1_DIFFUSION_SHAPES.items():
        rng = np.random.default_rng(S + D + BH)
        q, k, v = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                   dtype=torch.float32, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        scale = float(D) ** -0.5
        route, (o, lse, err, tol, lse_err, lse_tol) = route_of(
            mha_fwd, lambda: check_k1(q, k, v, scale, model))
        with torch.inference_mode():
            o2, lse2 = mha_fwd(q, k, v, scale, return_lse=True)
            torch.cuda.synchronize()
            if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
                raise AssertionError(f"K1 {model}: two runs differ")
            del o2, lse2
            # Inference writes no statistic.
            ms = cuda_ms(lambda: mha_fwd(q, k, v, scale),
                         launches=K1_LAUNCHES)
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, scale), reps=5)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale),
                launches=K1_LAUNCHES)
        # The block: consumer warpgroups of 64 rows.
        block = launch_plan(BH, S, S, D, _sms(dev))["fwd"]
        rows = 64 * block
        b_ms, b_by = k1_bound(BH, S, S, D)
        # Derived, not counted: a 30-step image's launches (the paths
        # count theirs in phases diffusion_text and image_to_3d).
        per_image = DIFFUSION_SITES * N_DIFFUSION_STEPS
        emit("k1_diffusion", model=model, shape=[BH, S, D], route=route,
             sites_per_unet_call=DIFFUSION_SITES,
             derived_launches_per_image=per_image, block_shape=block,
             blocks=S // rows * BH, max_abs_err=err, tol=tol,
             lse_max_abs_err=lse_err, lse_tol=lse_tol, bitwise_repeat=True,
             kernel_ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
             kernel_over_library=ms / sdpa_ms, bound_us=b_ms * 1e3,
             bound_by=b_by, derived_kernel_ms_per_image=ms * per_image)
        out[model] = dict(shape=[BH, S, D], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=sdpa_ms)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    return out


def phase_k1_bwd_diffusion(dev):
    """K1 (writing its row statistic, as in training) and K1ᵇ at the
    finetune's level-0 joint self-attention (``K1_TRAIN_SHAPES``: BH 4
    scenes x 5 heads), on seeded inputs against their plain versions;
    device times over K1_LAUNCHES calls beside the plain versions', SDPA's
    forward and backward and the bounds. Returns the kernels-line entries
    by model: K1's and K1ᵇ's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lgm_tpu_torch.ops.mha import (mha_bwd, mha_bwd_reference, mha_fwd,
                                       mha_reference)

    fwd, bwd = {}, {}
    for model, (BH, S, D) in K1_TRAIN_SHAPES.items():
        rng = np.random.default_rng(3 * S + BH)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(D) ** -0.5
        route, (o, lse, err, tol, lse_err, lse_tol) = route_of(
            mha_fwd, lambda: check_k1(q, k, v, scale, model))
        with torch.no_grad():
            b_route, (b_err, b_tol) = route_of(mha_bwd, lambda: check_k1b(
                q, k, v, o, do, scale, lse, model))
            # Two K1ᵇ runs give the same bits.
            first = mha_bwd(q, k, v, o, do, scale, lse)
            second = mha_bwd(q, k, v, o, do, scale, lse)
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"K1ᵇ {model}: two runs differ")
            del first, second
            ms = cuda_ms(lambda: mha_fwd(q, k, v, scale, return_lse=True),
                         launches=K1_LAUNCHES)
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, scale,
                                                     return_lse=True), reps=5)
            b_ms = cuda_ms(lambda: mha_bwd(q, k, v, o, do, scale, lse),
                           launches=K1_LAUNCHES)
            b_plain_ms = cuda_ms(lambda: mha_bwd_reference(
                q, k, v, o, do, scale, lse), reps=5)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale),
                launches=K1_LAUNCHES)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do[None], retain_graph=True),
            launches=K1_LAUNCHES)
        del out, qs, ks, vs
        f_bound, f_by = k1_bound(BH, S, S, D)
        b_bound, b_by = k1b_bound(BH, S, S, D)
        emit("k1_bwd_diffusion", model=model, shape=[BH, S, D],
             sites_per_step=DIFFUSION_SITES, k1_route=route,
             k1b_route=b_route, k1b_bitwise_repeat=True,
             k1_max_abs_err=err, k1_tol=tol,
             k1_lse_max_abs_err=lse_err, k1_lse_tol=lse_tol, k1_ms=ms,
             k1_plain_ms=plain_ms, k1_library_ms=sdpa_ms,
             k1_over_library=ms / sdpa_ms, k1_bound_us=f_bound * 1e3,
             k1_bound_by=f_by, k1_over_bound=ms / f_bound,
             k1b_max_abs_err=b_err, k1b_tol=b_tol, k1b_ms=b_ms,
             k1b_plain_ms=b_plain_ms, k1b_library_ms=sdpa_bwd_ms,
             k1b_over_library=b_ms / sdpa_bwd_ms, k1b_bound_us=b_bound * 1e3,
             k1b_bound_by=b_by, k1b_over_bound=b_ms / b_bound,
             k1b_ms_per_step=b_ms * DIFFUSION_SITES)
        fwd[model] = dict(shape=[BH, S, D], max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=f_bound, bound_by=f_by,
                          library_ms=sdpa_ms)
        bwd[model] = dict(shape=[BH, S, D], max_abs_err=b_err, ms=b_ms,
                          plain_ms=b_plain_ms, bound_ms=b_bound,
                          bound_by=b_by, library_ms=sdpa_bwd_ms)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return fwd, bwd


def timed(fn, stage: str, times: dict):
    """``fn`` timed from a device synchronize before each call to one after
    it, its wall seconds summed into ``times[stage]``."""
    import torch

    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times[stage] = times.get(stage, 0.0) + time.perf_counter() - t0
        return out
    return call


def process_clock():
    """A context in which spies time ``infer.process``'s two device calls:
    yields {"forward_s", "orbit_s"} (``infer.forward_gaussians``,
    ``infer.render_orbit_video``), as ``timed`` takes them."""
    import contextlib
    from unittest import mock

    from lgm_tpu_torch import infer

    @contextlib.contextmanager
    def clock():
        times = {}
        with mock.patch.object(infer, "forward_gaussians", timed(
                infer.forward_gaussians, "forward_s", times)), \
                mock.patch.object(infer, "render_orbit_video", timed(
                    infer.render_orbit_video, "orbit_s", times)):
            yield times

    return clock()


def stage_clock(pipe):
    """A context in which spies on ``pipe``'s methods time the pipeline's
    stages: yields {stage: wall seconds}, each call timed from a device
    synchronize before it to one after it and summed by stage (``clip_s``:
    the text and vision towers; ``vae_encode_s``, ``denoise_s``,
    ``decode_s``), and ``views_s``, ``infer.image_to_views``' resize of
    the generated views."""
    import contextlib
    from unittest import mock

    from lgm_tpu_torch import infer

    stages = {"encode_prompt": "clip_s", "encode_image": "clip_s",
              "encode_image_latents": "vae_encode_s",
              "denoise": "denoise_s", "decode": "decode_s"}

    @contextlib.contextmanager
    def clock():
        times = {}
        with contextlib.ExitStack() as stack:
            for method, stage in stages.items():
                stack.enter_context(mock.patch.object(
                    pipe, method, timed(getattr(pipe, method), stage,
                                        times)))
            stack.enter_context(mock.patch.object(
                infer, "resize", timed(infer.resize, "views_s", times)))
            yield times

    return clock()


def fixture_tokenizer(max_tokens: int):
    """The CLIP BPE tokenizer of the committed fixture (no published
    vocabulary is in the repository)."""
    from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer

    return CLIPTokenizer(os.path.join(ROOT, "tests", "fixtures",
                                      "clip_tokenizer"), max_tokens)


def seed_zero_layers(pipe, seed: int) -> int:
    """Draw, from PyTorch's default initialisation under ``seed``, the
    U-Net layers that ``from_config`` leaves at zero as ``lgm_tpu`` does
    (``mv_unet.zero_init_modules``: each SpatialTransformer's proj_out,
    each ResBlock's out conv, the final out conv): with them at zero the
    U-Net predicts ε = 0, and neither the paths behind them nor their
    gradients would be exercised. Raises if ``from_config`` did not leave
    them at zero; returns their number."""
    import torch

    from lgm_tpu_torch.diffusion.mv_unet import zero_init_modules

    mods = zero_init_modules(pipe.unet)
    if any(bool(m.weight.any()) or bool(m.bias.any()) for m in mods):
        raise AssertionError("from_config left a zero-init layer non-zero")
    dev = pipe.device
    with torch.random.fork_rng(devices=[dev.index or 0]
                               if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        for m in mods:
            m.reset_parameters()
    return len(mods)


def phase_diffusion_text(dev):
    """MVDream at its published widths (``CONFIGS["mvdream"]``: bf16 U-Net
    and VAE, f32 CLIP) with seeded random weights and the fixture
    tokenizer: "a red chair", guidance 7.5, 4 steps; K1 at exactly the 5
    level-0 sites of every U-Net call, the images finite in [0, 1]."""
    import numpy as np
    import torch

    import lgm_tpu_torch.diffusion.mv_unet as mv
    from lgm_tpu_torch.diffusion.pipeline import CONFIGS, MVDreamPipeline
    from lgm_tpu_torch.ops.mha import mha_fwd

    steps = 4
    t0 = time.perf_counter()
    pipe = MVDreamPipeline.from_config(
        "mvdream", seed=0, device=str(dev),
        tokenizer=fixture_tokenizer(CONFIGS["mvdream"].max_tokens))
    seed_zero_layers(pipe, seed=100)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    mha_fwd.launches = 0
    with route_counts(mv) as routes, stage_clock(pipe) as timings:
        t0 = time.perf_counter()
        images = pipe(prompt="a red chair", guidance_scale=7.5,
                      num_inference_steps=steps, seed=0)
        total_s = time.perf_counter() - t0
    launches = {"mha_fwd": mha_fwd.launches}
    expected = {"mha_fwd": DIFFUSION_SITES * steps}
    if launches != expected or routes["kernel"] != expected["mha_fwd"]:
        raise AssertionError(f"launches {launches}, expected {expected}; "
                             f"attention routes {routes}")
    if not (images.shape == (4, 256, 256, 3) and np.isfinite(images).all()
            and images.min() >= 0.0 and images.max() <= 1.0):
        raise AssertionError(f"images {images.shape}, finite "
                             f"{np.isfinite(images).all()}, range "
                             f"[{images.min()}, {images.max()}]")
    n_params = sum(p.numel() for m in pipe.modules().values()
                   for p in m.parameters())
    emit("diffusion_text", config="mvdream", params=n_params, load_s=load_s,
         steps=steps, guidance=7.5, images=list(images.shape),
         image_mean=float(images.mean()), image_std=float(images.std()),
         launches=launches, attention_routes=routes, total_s=total_s,
         step_ms=timings["denoise_s"] / steps * 1e3, **timings,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    del pipe
    torch.cuda.empty_cache()
    return launches


def phase_image_to_3d(dev, model):
    """The slice's path at full width: a seeded 512² RGBA (the port's
    render of ``sample_scene`` with its alpha, in OpenCV's BGRA order)
    through ``infer.image_to_views`` with ImageDream
    (``CONFIGS["imagedream"]``, ip_dim 16, seeded random weights, the
    fixture tokenizer; 30 steps, guidance 5.0, elevation 0), then LGM big's
    ``infer.process`` with phase ``main``'s model, for two objects one
    after the other (the process's first, then a warm one), each with
    exact launch counts (K1 150 in the pipeline + 16 in the LGM forward,
    K2 180) and its stage times; peak memory; then, on the last U-Net
    call's own inputs, one
    level-0 site's K1 output against its plain version, the U-Net's ε on
    the K1 route against the same call with the gate forced dense, and a
    profile of that call."""
    from unittest import mock

    import numpy as np
    import torch

    import lgm_tpu_torch.diffusion.mv_unet as mv
    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS as LGM_CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.diffusion.pipeline import CONFIGS, MVDreamPipeline
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.gsplat.api import render_views
    from lgm_tpu_torch.ops.mha import mha_fwd

    opt = LGM_CONFIGS["big"]
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    g = torch.as_tensor(sample_scene(np.random.default_rng(7), 65536),
                        device=dev)
    view = torch.as_tensor(infer.orbit_video_cameras(opt, 8)["cam_view"][1],
                           device=dev)
    with torch.inference_mode():
        r = render_views(g[None], view[None, None], 512, tan, dup=32)
        rgba = torch.cat([r["image"][0, 0], r["alpha"][0, 0]], -1)
    bgra = rgba.cpu().numpy()[..., [2, 1, 0, 3]]
    del g, r, rgba

    t0 = time.perf_counter()
    pipe = MVDreamPipeline.from_config(
        "imagedream", seed=1, device=str(dev),
        tokenizer=fixture_tokenizer(CONFIGS["imagedream"].max_tokens))
    seed_zero_layers(pipe, seed=101)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    # Spies, not on the counted wrappers: the last U-Net call's inputs
    # and one level-0 site's q, k, v, scale and output.
    captured = {}
    unet_forward = pipe.unet.forward

    def spy_unet(*args, **kw):
        captured["unet"] = (args, kw)
        return unet_forward(*args, **kw)

    def spy_mha(mha):
        def call(q, k, v, scale):
            o = mha(q, k, v, scale)
            captured["site"] = (q, k, v, scale, o)
            return o
        return call

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    # LGM big's attention sites (phase main checks that LGM big in bf16
    # takes the kernel route at all of them).
    lgm_sites = sum(type(m).__name__ == "MVAttention"
                    for m in model.modules())
    expected = {"mha_fwd": DIFFUSION_SITES * N_DIFFUSION_STEPS + lgm_sites,
                "composite_fwd": 180}

    def one_object():
        """image -> views -> LGM -> .ply and orbit, counted and timed."""
        mha_fwd.launches = 0
        fs.composite_fwd.launches = 0
        k1_before = k1_route_launches()
        with route_counts(mv) as routes, stage_clock(pipe) as times, \
                process_clock() as clock, \
                mock.patch.object(pipe.unet, "forward", spy_unet), \
                mock.patch.object(mv, "mha", spy_mha(mv.mha)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            views = infer.image_to_views(pipe, bgra, opt, elevation=0.0)
            res = infer.process(opt, views, os.path.join(work, "image_to_3d"),
                                device=str(dev), model=model)
            torch.cuda.synchronize()
            times["image_to_3d_s"] = time.perf_counter() - t0
        launches = {"mha_fwd": mha_fwd.launches,
                    "composite_fwd": fs.composite_fwd.launches}
        k1_routes = k1_route_launches(k1_before)["mha_fwd"]
        if launches != expected or routes["kernel"] != (
                DIFFUSION_SITES * N_DIFFUSION_STEPS) or k1_routes[
                    "wgmma"] < DIFFUSION_SITES * N_DIFFUSION_STEPS:
            raise AssertionError(f"launches {launches}, expected "
                                 f"{expected}; diffusion attention routes "
                                 f"{routes}; K1 routes {k1_routes}")
        launches["mha_fwd_routes"] = k1_routes
        gs = res["gaussians"]
        if not (views.shape == (4, opt.input_size, opt.input_size, 3)
                and np.isfinite(views).all() and views.min() >= 0.0
                and views.max() <= 1.0 and np.isfinite(gs).all()
                and gs.shape == (1, 4 * opt.splat_size ** 2, 14)
                and res["frames"].shape == (180, opt.output_size,
                                            opt.output_size, 3)):
            raise AssertionError(
                f"views {views.shape} in [{views.min()}, {views.max()}], "
                f"gaussians {gs.shape} finite {np.isfinite(gs).all()}, "
                f"frames {res['frames'].shape}")
        times.update(clock,
                     step_ms=times["denoise_s"] / N_DIFFUSION_STEPS * 1e3)
        return launches, routes, times, views.shape, gs.shape

    # The process's first object (its first run of the vision tower, the
    # ip branch and the VAE encoder), then a second one: the warm time is
    # the metric, the first is printed beside it.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, first, _, _ = one_object()
    launches, routes, timings, views_shape, gs_shape = one_object()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30

    # The level-0 site on its own inputs: what the U-Net got from K1 is
    # K1's output again (deterministic), within K1's tolerance of the
    # plain version.
    q, k, v, scale, site_o = captured["site"]
    site_shape = list(q.shape)
    with torch.inference_mode():
        o, _, site_err, site_tol, _, _ = check_k1(q, k, v, scale,
                                                  "image_to_3d site")
        if not torch.equal(o, site_o):
            raise AssertionError("K1 on the site's inputs differs from the "
                                 "output the U-Net used")
        del q, k, v, site_o, o
        # The whole U-Net's ε on the K1 route against the gate forced
        # dense, on the last call's own inputs, each CFG branch held
        # (relative RMS error, EPS_ROUTE_REL_TOL). The uncond branch's ip
        # frame is the all-zero latent; at ImageDream's widths its first
        # GroupNorm sees 10 channels a group, each with its own stem bias,
        # so that branch is as well conditioned as the cond one.
        args, kw = captured["unet"]
        eps = unet_forward(*args, **kw).float()
        with mock.patch.object(mv, "kernel_route", lambda *a: False):
            eps_dense = unet_forward(*args, **kw).float()
        half = eps.shape[0] // 2
        branch = {}
        for name, sl in (("uncond", slice(0, half)),
                         ("cond", slice(half, None))):
            diff = eps[sl] - eps_dense[sl]
            branch[name] = dict(
                max_abs_err=float(diff.abs().max()),
                scale=float(eps_dense[sl].abs().max()),
                rel_rms_err=float(diff.norm() / eps_dense[sl].norm()))
        if not (torch.isfinite(eps).all()
                and all(b["rel_rms_err"] <= EPS_ROUTE_REL_TOL
                        for b in branch.values())):
            raise AssertionError(f"U-Net ε, K1 route vs dense: {branch}, "
                                 f"tol {EPS_ROUTE_REL_TOL}")
        del eps, eps_dense
    emit("image_to_3d", config="imagedream", lgm="big",
         input=list(bgra.shape), load_s=load_s,
         steps=N_DIFFUSION_STEPS, guidance=5.0, launches=launches,
         diffusion_attention_routes=routes, **timings, first_call=first,
         peak_mem_gb=peak_gb, views=list(views_shape),
         gaussians=list(gs_shape), site_shape=site_shape,
         site_max_abs_err=site_err, site_tol=site_tol,
         eps_k1_vs_dense=branch, eps_rel_tol=EPS_ROUTE_REL_TOL)
    with torch.inference_mode():
        profile_window("unet_imagedream",
                       lambda: unet_forward(*args, **kw))
    del pipe, captured, args, kw
    torch.cuda.empty_cache()
    return launches


def phase_diffusion_train(dev, name):
    """The diffusion finetune at ``name``'s published widths (MVDream or
    ImageDream: bf16 U-Net over f32 parameters, the frozen VAE and CLIP
    towers, the fixture tokenizer), from ``from_config`` (repair R2: the
    output layers at zero, checked, then drawn here from a seed so that
    every layer has a gradient), through ``DiffusionTrainer.train_step``
    at lr 1e-4, warmup 1, EMA 0.9999, cond-drop 0.1, on one fixed
    synthetic batch (4 scenes x 4 frames at 256², rendered anew each
    step: K2, B·F launches): DIFFUSION_TRAIN_STEPS steps, the first
    DIFFUSION_COLD_STEPS cold. Per step: the step's time, the batch's
    (render, then the encoders of ``prepare_batch``), the exact launches
    of K1, K1ᵇ and K2; K1 and K1ᵇ on the first step's own inputs, K2 on
    the first batch's first render; the
    U-Net gradients on the K1 route against the gate forced dense on the
    first step's prepared batch; the loss on that batch after the steps
    below the first step's; then a profile of a warm step. Returns the
    launches a step and a batch."""
    import contextlib
    import gc
    from unittest import mock

    import numpy as np
    import torch

    import lgm_tpu_torch.diffusion.mv_unet as mv
    from lgm_tpu_torch.diffusion.data import SyntheticMVData
    from lgm_tpu_torch.diffusion.pipeline import CONFIGS, MVDreamPipeline
    from lgm_tpu_torch.diffusion.train import DiffusionTrainer, diffusion_loss
    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    t0 = time.perf_counter()
    pipe = MVDreamPipeline.from_config(
        name, seed=2, device=str(dev),
        tokenizer=fixture_tokenizer(CONFIGS[name].max_tokens))
    zero_layers = seed_zero_layers(pipe, seed=102)
    trainer = DiffusionTrainer(pipe, lr=1e-4, warmup=1, cond_drop=0.1,
                               seed=0, ema_decay=0.9999)
    ds = SyntheticMVData(num_frames=DIFFUSION_FRAMES,
                         image_size=DIFFUSION_SIZE, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.optimizer.params)

    counters = (mha_mod.mha_fwd, mha_mod.mha_bwd, fs.composite_fwd)
    prepared, captured = [], {}
    prepare = trainer.prepare_batch

    def timed_prepare(data):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = prepare(data)
        torch.cuda.synchronize()
        prepared.append((batch, time.perf_counter() - t))
        return batch

    rec = {"step_s": [], "render_s": [], "prepare_s": [], "loss": [],
           "gnorm": [], "launches": [], "batch_launches": []}
    composite = fs.composite

    def render_spy(params, counts, th, tw, tiles_x):
        # The first batch's first K2 call: its inputs and its output.
        out = composite(params, counts, th, tw, tiles_x)
        captured.setdefault("k2", (params, counts, th, tw, tiles_x, out))
        return out

    for fn in counters:
        fn.launches = 0
    k1_before = k1_route_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with route_counts(mv) as routes, \
            mock.patch.object(trainer, "prepare_batch", timed_prepare):
        for i in range(DIFFUSION_TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            k2_before = counters[2].launches
            with contextlib.ExitStack() as stack:
                if i == 0:
                    stack.enter_context(mock.patch.object(
                        fs, "composite", render_spy))
                data = ds.batch(0, DIFFUSION_BATCH)
            rec["render_s"].append(time.perf_counter() - t)
            rec["batch_launches"].append(counters[2].launches - k2_before)
            before = [fn.launches for fn in counters]
            t = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for spy in backward_spies(captured) if i == 0 else ():
                    stack.enter_context(spy)
                m = trainer.train_step(data)
            torch.cuda.synchronize()
            step_total = time.perf_counter() - t
            rec["prepare_s"].append(prepared[-1][1])
            rec["step_s"].append(step_total - prepared[-1][1])
            rec["launches"].append([fn.launches - b for fn, b in
                                    zip(counters, before)])
            rec["loss"].append(float(m["loss"]))
            rec["gnorm"].append(float(m["gnorm"]))
    k1_routes = k1_route_launches(k1_before)
    if any(n for counts in k1_routes.values() for r, n in counts.items()
           if r != mha_mod.route(64)):
        raise AssertionError(f"{name}: K1/K1ᵇ routes {k1_routes} (the "
                             f"level-0 sites, D 64, take "
                             f"{mha_mod.route(64)})")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    per_step = [DIFFUSION_SITES, DIFFUSION_SITES, 0]
    per_batch = DIFFUSION_BATCH * DIFFUSION_FRAMES
    if (any(l != per_step for l in rec["launches"])
            or any(n != per_batch for n in rec["batch_launches"])
            or routes["kernel"] != DIFFUSION_SITES * DIFFUSION_TRAIN_STEPS
            or not np.isfinite(rec["loss"] + rec["gnorm"]).all()):
        raise AssertionError(f"{name}: launches {rec['launches']} a step "
                             f"(expected {per_step}), "
                             f"{rec['batch_launches']} a batch (expected "
                             f"{per_batch}), routes {routes}, losses "
                             f"{rec['loss']}, gnorms {rec['gnorm']}")

    # K1 and K1ᵇ on the first step's own inputs (the deepest site's).
    q, k, v, o, do, scale, lse = captured["k1"]
    with torch.no_grad():
        o2, lse2, k1_err, _, _, _ = check_k1(q, k, v, scale, name)
        if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
            raise AssertionError(f"K1 on the {name} step's inputs differs "
                                 "from the step's own o or lse")
        k1b_err, k1b_tol = check_k1b(q, k, v, o, do, scale, lse, name)
        # K2 on the first batch's first render: what it gives again is
        # what the batch rendered (the kernel is deterministic), held
        # against its plain version.
        params, counts, th, tw, tiles_x, out = captured["k2"]
        if not torch.equal(fs.composite_fwd(params, counts, th, tw, tiles_x),
                           out):
            raise AssertionError(f"K2 on the {name} batch's view differs "
                                 "from the batch's own render")
        k2_err = float((out - fs.composite_reference(
            params, counts, th, tw, tiles_x)).abs().max())
        if not k2_err <= K2_ATOL:
            raise AssertionError(f"K2 {name} batch: max abs err {k2_err}")
        k2_shape = [list(params.shape), th, tw, tiles_x]
    site_shape = list(q.shape)
    captured.clear()
    del q, k, v, o, do, lse, o2, lse2, params, counts, out

    # The U-Net gradients on the first step's prepared batch, K1 route
    # against the gate forced dense (relative RMS over all leaves), and
    # the loss there after the steps against the first step's.
    batch0 = prepared[0][0]
    prepared.clear()
    params = trainer.optimizer.params

    def grads():
        for p in params:
            p.grad = None
        loss = diffusion_loss(trainer.unet, batch0, trainer.alphas_cumprod,
                              trainer.ip)
        loss.backward()
        out = [p.grad for p in params]
        for p in params:
            p.grad = None
        return loss.item(), out

    for fn in counters:
        fn.launches = 0
    loss_k1, g_k1 = grads()
    if (mha_mod.mha_fwd.launches, mha_mod.mha_bwd.launches) != (
            DIFFUSION_SITES, DIFFUSION_SITES):
        raise AssertionError("the gradient check did not take the K1 route")
    with mock.patch.object(mv, "kernel_route", lambda *a: False):
        loss_dense, g_dense = grads()
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(g_k1, g_dense))
    den = sum(float(b.float().square().sum()) for b in g_dense)
    grad_rel_rms = (num / den) ** 0.5
    del g_k1, g_dense
    if not grad_rel_rms <= EPS_ROUTE_REL_TOL:
        raise AssertionError(f"{name}: U-Net gradients, K1 route vs dense: "
                             f"relative RMS {grad_rel_rms} > "
                             f"{EPS_ROUTE_REL_TOL}")
    if not loss_k1 < rec["loss"][0]:
        raise AssertionError(f"{name}: loss on the first batch after "
                             f"{DIFFUSION_TRAIN_STEPS} steps {loss_k1}, "
                             f"not below the first step's {rec['loss'][0]}")
    warm = rec["step_s"][DIFFUSION_COLD_STEPS:]
    loader = [r + p for r, p in zip(rec["render_s"], rec["prepare_s"])]
    emit("diffusion_train", config=name, params=n_params, load_s=load_s,
         zero_init_layers=zero_layers, batch=[DIFFUSION_BATCH,
                                               DIFFUSION_FRAMES,
                                               DIFFUSION_SIZE],
         compute_dtype=CONFIGS[name].compute_dtype, lr=1e-4, warmup=1,
         ema_decay=0.9999, steps=DIFFUSION_TRAIN_STEPS,
         cold_steps=DIFFUSION_COLD_STEPS, steps_s=rec["step_s"],
         step_warm_s=median(warm), step_warm_spread_s=max(warm) - min(warm),
         render_s=rec["render_s"], prepare_s=rec["prepare_s"],
         batch_warm_s=median(loader[DIFFUSION_COLD_STEPS:]),
         peak_mem_gb=peak_gb, loss=rec["loss"], gnorm=rec["gnorm"],
         loss_first_batch_after=loss_k1, loss_first_batch_dense=loss_dense,
         launches_per_step=dict(zip(("mha_fwd", "mha_bwd"), per_step)),
         composite_fwd_per_batch=per_batch, attention_routes=routes,
         k1_route_launches=k1_routes,
         site_shape=site_shape, k1_max_abs_err=k1_err,
         k1_bwd_max_abs_err=k1b_err, k1_bwd_tol=k1b_tol,
         k2_shape=k2_shape, k2_max_abs_err=k2_err, k2_atol=K2_ATOL,
         grad_k1_vs_dense_rel_rms=grad_rel_rms,
         grad_rel_tol=EPS_ROUTE_REL_TOL)
    # One warm step (the batch prepared inside it) under the profiler.
    profile_window(f"diffusion_train_{name}",
                   lambda: trainer.train_step(data))
    del trainer, pipe, batch0, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"mha_fwd": per_step[0] * DIFFUSION_TRAIN_STEPS,
            "mha_bwd": per_step[1] * DIFFUSION_TRAIN_STEPS,
            "composite_fwd": per_batch * DIFFUSION_TRAIN_STEPS,
            "per_step": {"mha_fwd": per_step[0], "mha_bwd": per_step[1]},
            "per_batch": {"composite_fwd": per_batch}}


def phase_diffusion_train_cli(dev, root):
    """``python -m torch.distributed.run --nproc_per_node 1 -m
    lgm_tpu_torch.diffusion.train --pipeline mvdream --data-mode lvis``
    as a user runs it, on the card (NCCL, world size 1): on
    ``disk_dataset``'s scenes, batch 4, 3 steps, the checkpoint and the
    export; then ``MVDreamPipeline.from_pretrained`` of the export: its
    U-Net is the EMA in ``dckpt_3`` bit for bit, and it samples 2 DDIM
    steps on the card. Both written trees are deleted after."""
    import shutil
    import sys

    import numpy as np
    import torch

    from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline

    ws = os.path.join(ROOT, "build", "smoke", "diffusion_cli")
    export = os.path.join(ws, "export")
    if os.path.isdir(ws):
        shutil.rmtree(ws)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), "-m", "lgm_tpu_torch.diffusion.train",
           "--pipeline", "mvdream", "--tokenizer",
           os.path.join(ROOT, "tests", "fixtures", "clip_tokenizer"),
           "--data-mode", "lvis", "--data-path", root, "--batch-size",
           str(DIFFUSION_BATCH), "--image-size", str(DIFFUSION_SIZE),
           "--total-steps", "3", "--workspace", ws, "--export", export,
           "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, PYTHONPATH=ROOT))
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"diffusion train CLI exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    ckpt_path = os.path.join(ws, "dckpt_3")
    ckpt_gb = os.path.getsize(ckpt_path) / 2**30
    export_gb = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(export) for f in fs) / 2**30
    with open(os.path.join(ws, "metrics.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    t0 = time.perf_counter()
    pipe = MVDreamPipeline.from_pretrained(export, device=str(dev))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True,
                      mmap=True)
    ours = pipe.unet.state_dict()
    if sorted(ours) != sorted(ckpt["ema"]) or not all(
            torch.equal(ours[n].cpu(), ckpt["ema"][n]) for n in ours):
        raise AssertionError("the exported U-Net is not dckpt_3's EMA")
    step = int(ckpt["step"])
    del ckpt, ours
    t0 = time.perf_counter()
    images = pipe(prompt="a red chair", guidance_scale=7.5,
                  num_inference_steps=2, seed=0, height=DIFFUSION_SIZE,
                  width=DIFFUSION_SIZE)
    sample_s = time.perf_counter() - t0
    size = DIFFUSION_SIZE
    if not (step == 3 and images.shape == (4, size, size, 3)
            and np.isfinite(images).all() and len(logged) == 1
            and np.isfinite(logged[0]["diffusion/loss"])):
        raise AssertionError(f"step {step}, images {images.shape}, logged "
                             f"{logged}")
    emit("diffusion_train_cli", pipeline="mvdream", data="lvis",
         batch_size=DIFFUSION_BATCH, steps=3,
         process_group="nccl" if dev.type == "cuda" else "gloo", wall_s=wall_s,
         logged=logged[0], checkpoint_gb=ckpt_gb, export_gb=export_gb,
         from_pretrained_s=load_s, ema_equals_export=True, sample_steps=2,
         sample_s=sample_s, images=list(images.shape),
         stdout_tail=proc.stdout.strip().splitlines()[-3:])
    del pipe
    torch.cuda.empty_cache()
    shutil.rmtree(ws)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rgba_views(dev, seed: int, n_views: int, size: int, els, azs):
    """A seeded ``sample_scene`` (4,096 splats) rendered by the port at
    orbit poses (elevation, azimuth) of radius 1.5: uint8 RGBA [V, S, S,
    4], straight (not premultiplied) colour and its alpha, as a renderer
    writes an RGBA file."""
    import numpy as np
    import torch

    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.ops.gsplat.api import render_views
    from lgm_tpu_torch.utils import camera

    g = torch.as_tensor(sample_scene(np.random.default_rng(seed), 4096),
                        device=dev)
    poses = np.stack([camera.orbit_camera(e, a, 1.5)
                      for e, a in zip(els, azs)])
    cams = camera.build_camera_inputs(poses, 49.1, 0.5, 2.5)
    tan = float(np.tan(0.5 * np.deg2rad(49.1)))
    with torch.inference_mode():
        out = render_views(g[None], torch.as_tensor(
            cams["cam_view"], device=dev)[None], size, tan,
            bg_color=torch.zeros(1, n_views, 3, device=dev),
            with_depth=False, dup=32)
        alpha = out["alpha"][0].clamp(0, 1)
        rgb = (out["image"][0] / alpha.clamp_min(1e-6)).clamp(0, 1)
        rgba = torch.cat([rgb * (alpha > 0), alpha], -1)
    return (rgba * 255).to(torch.uint8).cpu().numpy()


def phase_png_codec(dev):
    """The port's PNG codec at the disk dataset's size: a seeded 512² RGBA
    render written with each filter and with the adaptive choice, read
    back bit for bit; the C++ unfilter against the plain one on each
    file's first rows (the plain loop takes seconds a view); decode and
    ``load_views`` (512 and 256) ms a view."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from lgm_tpu_torch.data.decode import load_views
    from lgm_tpu_torch.io import png

    S = 512
    views = rgba_views(dev, 3, 8, S, [10.0] * 8, np.arange(8) * 45.0)
    img = views[0]
    work = os.path.join(ROOT, "build", "smoke", "png")
    os.makedirs(work, exist_ok=True)
    files = {}
    for name, ftype in [("adaptive", None)] + [(f"filter{f}", f)
                                               for f in range(5)]:
        t0 = time.perf_counter()
        data = png.encode(img, ftype)
        encode_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(png.decode_rgba(data)[0], img):
            raise AssertionError(f"png {name}: read back differs")
        rows = 16
        # The encoder's one IDAT chunk sits after the 33 bytes of
        # signature and IHDR, and before IEND's 12.
        raw = np.frombuffer(zlib.decompress(data[33 + 8:-12 - 4]), np.uint8)
        part = raw[:rows * (S * 4 + 1)]
        if not np.array_equal(png.unfilter(part, rows, S * 4, 4),
                              png.unfilter_plain(part, rows, S * 4, 4)):
            raise AssertionError(f"png {name}: C++ unfilter != plain")
        files[name] = dict(bytes=len(data), encode_ms=encode_ms,
                           filters=np.bincount(raw.reshape(S, -1)[:, 0],
                                               minlength=5).tolist())
    data = png.encode(img)
    decode_ms = median([_timed_ms(lambda: png.decode_rgba(data))
                        for _ in range(5)])
    paths = [os.path.join(work, f"{i:03d}.png") for i in range(8)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(png.write, paths, views))
    load_ms = median([_timed_ms(lambda: load_views(paths, S, 256,
                                                   n_threads=4)) / 8
                      for _ in range(3)])
    emit("png_codec", size=S, files=files, decode_ms_per_view=decode_ms,
         load_views_ms_per_view=load_ms, load_views_threads=4,
         unfilter_checked_rows=16, bitwise_roundtrip=True)


def _timed_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


# The committed JPEG fixtures and their manifest (scripts/
# make_jpeg_fixtures.py): the SHA-256 of cv2's decode of each file taken,
# the class of each file refused. view0-view3 are a seeded render at
# azimuths 0/90/180/270, 256²: the JPEG inputs of infer_cli and app_http.
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
JPEG_VIEWS = [os.path.join(JPEG_FIXTURES, f"view{i}.jpg") for i in range(4)]
# The same views written progressive (pview0-pview3).
PROGRESSIVE_VIEWS = [os.path.join(JPEG_FIXTURES, f"pview{i}.jpg")
                     for i in range(4)]
JPEG_BENCH = {"bench512": 512, "bench1024": 1024, "pbench512": 512,
              "pbench1024": 1024}


def phase_jpeg_codec():
    """The port's JPEG decoder built on this host (no image library) and
    held to the manifest: every fixture it takes decodes to the SHA-256
    of cv2's decode (tests/test_torch_jpeg.py checks the manifest against
    cv2), sequential and progressive, every refused class raises
    ``JpegError``; the decode ms of the 512² and 1024² 4:2:0 fixtures of
    each kind (median of 9, one thread); and whether ``cv2`` imports on
    this host (the port does not need it)."""
    import hashlib

    from lgm_tpu_torch.io import jpeg

    t0 = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t0
    with open(os.path.join(JPEG_FIXTURES, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    for name, entry in manifest["taken"].items():
        arr = jpeg.imread(os.path.join(JPEG_FIXTURES, name))
        digest = hashlib.sha256(arr.tobytes()).hexdigest()
        if digest != entry["sha256"] or list(arr.shape) != entry["shape"]:
            raise AssertionError(f"jpeg: {name} decodes to {arr.shape} "
                                 f"{digest[:12]}, not cv2's")
    refused = {}
    for name, cls in manifest["refused"].items():
        try:
            jpeg.imread(os.path.join(JPEG_FIXTURES, name))
        except jpeg.JpegError as exc:
            refused[cls] = str(exc)
        else:
            raise AssertionError(f"jpeg: {name} ({cls}) was not refused")
    progressive = []
    for name in manifest["taken"]:
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as fh:
            if b"\xff\xc2" in fh.read():
                progressive.append(name)
    decode_ms = {}
    for name in JPEG_BENCH:
        with open(os.path.join(JPEG_FIXTURES, f"{name}.jpg"), "rb") as fh:
            data = fh.read()
        jpeg.decode(data)
        decode_ms[name] = median([_timed_ms(lambda: jpeg.decode(data))
                                  for _ in range(9)])
    probe = subprocess.run([sys.executable, "-c",
                            "import cv2; print(cv2.__version__)"],
                           capture_output=True, text=True, timeout=120)
    emit("jpeg_codec", build_s=build_s, taken=len(manifest["taken"]),
         progressive_taken=sorted(progressive),
         digests_equal_cv2=True, refused=refused, decode_ms=decode_ms,
         progressive_over_sequential={
             k: decode_ms[f"p{k}"] / decode_ms[k]
             for k in ("bench512", "bench1024")},
         mpixel_per_s={k: (JPEG_BENCH[k] ** 2 / 1e6) / (ms / 1e3)
                       for k, ms in decode_ms.items()},
         cv2_on_host=probe.stdout.strip() if probe.returncode == 0
         else None)


def phase_disk_dataset(dev):
    """An LVIS-layout dataset written into ``build/smoke/lvis``: 3 x the
    batch of scenes (16 train and 8 test at bs 8), 12 views each at the
    preset's output size (512²), RGBA PNGs by the port's writer, each
    scene a seeded ``sample_scene`` rendered by the port; input views 1-4
    at one elevation, 90° apart, the others at random poses; each
    ``NNN.npy`` stores the elevation negated, as ``LVISDataset._parse_pose``
    flips it. Cut: the scene count only (the reference trains on tens of
    thousands of objects)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.io import png

    opt = CONFIGS["big"]
    n_scenes, n_views, S = 3 * opt.batch_size, 12, opt.output_size
    root = os.path.join(ROOT, "build", "smoke", "lvis")
    if os.path.isdir(root):
        import shutil

        shutil.rmtree(root)
    t0 = time.perf_counter()
    jobs, nbytes = [], 0
    for s in range(n_scenes):
        rng = np.random.default_rng((11, s))
        els = rng.uniform(-30.0, 30.0, n_views)
        azs = rng.uniform(0.0, 360.0, n_views)
        els[1:5] = rng.uniform(-10.0, 10.0)
        azs[1:5] = rng.uniform(0.0, 360.0) + 90.0 * np.arange(4)
        views = rgba_views(dev, 1000 + s, n_views, S, els, azs)
        scene = os.path.join(root, "00000-09999", f"scene{s:04d}")
        os.makedirs(scene)
        for v in range(n_views):
            np.save(os.path.join(scene, f"{v:03d}.npy"),
                    {"elevation": -els[v], "azimuth": azs[v],
                     "radius": 1.5})
            jobs.append((os.path.join(scene, f"{v:03d}.png"), views[v]))
    with ThreadPoolExecutor(8) as pool:
        nbytes = sum(pool.map(lambda job: png.write(*job), jobs))
    write_s = time.perf_counter() - t0
    emit("disk_dataset", root=os.path.relpath(root, ROOT), scenes=n_scenes,
         train_scenes=n_scenes - opt.batch_size,
         test_scenes=opt.batch_size, views=n_views, size=S,
         write_s=write_s, png_bytes=nbytes,
         bytes_per_view=nbytes / (n_scenes * n_views),
         reduced=["scene count: 24, against the tens of thousands of "
                  "objects the reference trains on"])
    return root


def phase_loader(dev, root):
    """The port's loader at LGM big's shapes (bs 8, 8 views, 512 out, 256
    in) over ``num_workers`` spawned worker processes, pinned, on the
    training split listed 8 times (one epoch of 16 batches, as a long
    dataset gives): the first batch (worker start included), then
    samples/s and batches/s from the first batch to the last; and one
    sample in this process."""
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data import provider

    opt = CONFIGS["big"].replace(data_mode="lvis", data_path_rendering=root)
    ds = provider.LVISDataset(opt, training=True)
    one_ms = median([_timed_ms(lambda: ds[0]) for _ in range(3)])
    ds.items = ds.items * 8
    loader = provider.Loader(ds, opt.batch_size, workers=opt.num_workers,
                             pin_memory=True)
    t0 = time.perf_counter()
    arrivals, shapes = [], None
    for batch in loader.epoch(0):
        arrivals.append(time.perf_counter() - t0)
        shapes = {k: list(v.shape) for k, v in batch.items()}
    loader.close()
    n = len(arrivals)
    rate = (n - 1) / (arrivals[-1] - arrivals[0])
    emit("loader", batch_size=opt.batch_size, num_views=opt.num_views,
         output_size=opt.output_size, input_size=opt.input_size,
         workers=opt.num_workers, batches=n, shapes=shapes,
         first_batch_s=arrivals[0], total_s=arrivals[-1],
         batches_per_s=rate, samples_per_s=rate * opt.batch_size,
         arrivals_s=arrivals, one_sample_ms=one_ms)


def phase_train_disk(dev, root):
    """``train.main`` as a user runs it, in this process: LGM big at its
    published widths with seeded weights, from the disk dataset (``lvis``,
    bs 8, 8 views, 8 loader processes), under ``torchrun``'s environment
    for one rank (NCCL; DistributedDataParallel around the LGM), the
    preset's U-Net recompute on, 6 steps, the eval and the checkpoint;
    then ``--zero1 1`` for 2 steps. Per step: the step's time, the time
    the trainer waited on the loader and the exact launches of K1, K1ᵇ,
    K2 and K2ᵇ; K1, K1ᵇ and K2ᵇ held against their plain versions on the
    first step's own inputs."""
    import contextlib
    import gc
    import json
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from lgm_tpu_torch import train
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.models.unet import MVAttention
    from lgm_tpu_torch.ops import mha as mha_mod
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    opt = CONFIGS["big"]
    counters = (mha_mod.mha_fwd, mha_mod.mha_bwd, fs.composite_fwd,
                fs.composite_bwd)
    orig_step, orig_datasets = train.train_step, train.make_datasets

    def run(ws, steps, extra, spies):
        record = {"step_s": [], "wait_s": [], "launches": []}
        seen = {}

        def step_spy(state, data, bg):
            torch.cuda.synchronize()
            before = [fn.launches for fn in counters]
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for spy in spies if not record["step_s"] else ():
                    stack.enter_context(spy)
                m = orig_step(state, data, bg)
            torch.cuda.synchronize()
            record["step_s"].append(time.perf_counter() - t0)
            record["launches"].append([fn.launches - b for fn, b in
                                       zip(counters, before)])
            record.setdefault("loss", []).append(float(m["loss"]))
            if "backend" not in seen:
                seen.update(
                    backend=torch.distributed.get_backend(),
                    wrapper=type(state.model.lgm).__name__,
                    sites=sum(isinstance(x, MVAttention)
                              for x in state.model.modules()),
                    dims=k1_site_dims(state.model),
                    batch={k: list(v.shape) for k, v in data.items()})
            return m

        def datasets_spy(*args, **kw):
            train_ds, test_ds = orig_datasets(*args, **kw)
            batch = train_ds.batch

            def timed(step):
                t0 = time.perf_counter()
                out = batch(step)
                record["wait_s"].append(time.perf_counter() - t0)
                return out

            train_ds.batch = timed
            return train_ds, test_ds

        if os.path.isdir(ws):
            shutil.rmtree(ws)
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
        argv = ["big", "--device", dev.type, "--data-mode", "lvis",
                "--data-path-rendering", root, "--workspace", ws,
                "--total-steps", str(steps), *extra]
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env), \
                mock.patch.object(train, "train_step", step_spy), \
                mock.patch.object(train, "make_datasets", datasets_spy):
            train.main(argv)
        record["main_s"] = time.perf_counter() - t0
        gc.collect()
        record["total_launches"] = {fn.__name__: fn.launches
                                    for fn in counters}
        record["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(os.path.join(ws, "metrics.jsonl")) as fh:
            record["eval"] = [{k[5:]: v for k, v in json.loads(line).items()
                               if k.startswith("eval/")}
                              for line in fh if '"eval/' in line]
        record["ckpt"] = train.latest_checkpoint(ws)
        record.update(seen)
        return record

    def expected(rec, steps):
        """Launches a step, from the code: K1 at every attention site in
        the forward and again in the U-Net's recompute, K1ᵇ at every site,
        K2 (with its state) and K2ᵇ on every supervision view (B x V),
        none for batches (the images come from disk); the eval renders
        its batch's views once and runs the forward once."""
        sites, views = rec["sites"], opt.batch_size * opt.num_views
        per_step = [sites * (2 if opt.unet_remat else 1), sites, views,
                    views]
        total = {"mha_fwd": steps * per_step[0] + sites,
                 "mha_bwd": steps * per_step[1],
                 "composite_fwd": steps * per_step[2] + views,
                 "composite_bwd": steps * per_step[3]}
        return per_step, total

    captured = {}
    ws = os.path.join(ROOT, "build", "smoke", "train_disk")
    k1_before = k1_route_launches()
    main_rec = run(ws, 6, [], backward_spies(captured))
    per_step, total = expected(main_rec, 6)
    # Per site: K1 in each step's forward and recompute and in the eval,
    # K1ᵇ each step.
    k1_routes = check_k1_routes(
        "train_disk", k1_before, main_rec["dims"],
        {"mha_fwd": 6 * (2 if opt.unet_remat else 1) + 1, "mha_bwd": 6})
    if (any(l != per_step for l in main_rec["launches"])
            or main_rec["total_launches"] != total):
        raise AssertionError(f"train_disk launches {main_rec['launches']} "
                             f"(total {main_rec['total_launches']}), "
                             f"expected {per_step} a step, {total}")
    if not (main_rec["backend"] == ("nccl" if dev.type == "cuda" else
                                    "gloo")
            and main_rec["wrapper"] == "DistributedDataParallel"):
        raise AssertionError(f"process group {main_rec['backend']}, "
                             f"wrapper {main_rec['wrapper']}")
    evals = main_rec["eval"]
    if not (np.isfinite(main_rec["loss"]).all() and len(evals) == 1
            and np.isfinite(list(evals[0].values())).all()
            and main_rec["ckpt"].endswith("ckpt_6")):
        raise AssertionError(f"losses {main_rec['loss']}, evals {evals}, "
                             f"checkpoint {main_rec['ckpt']}")

    # K1, K1ᵇ and K2ᵇ on the first step's own inputs.
    q, k, v, o, do, scale, lse = captured["k1"]
    with torch.no_grad():
        o2, lse2, k1_err, _, k1_lse_err, _ = check_k1(q, k, v, scale,
                                                      "train_disk")
        if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
            raise AssertionError("K1 on the disk step's inputs differs from "
                                 "the step's own o or lse")
        k1b_err, k1b_tol = check_k1b(q, k, v, o, do, scale, lse,
                                     "train_disk")
        params, counts, fo, go, k2_state, th, tw, tiles_x = captured["k2"]
        k2b_err, k2b_rel = check_k2b(params, counts, fo, go, k2_state, th,
                                     tw, tiles_x, "train_disk")
    k1_shape = list(q.shape)
    captured.clear()
    del q, k, v, o, do, lse, o2, lse2, params, counts, fo, go, k2_state
    torch.cuda.empty_cache()

    warm = median(main_rec["step_s"][1:])
    emit("train_disk", preset="big", batch_size=opt.batch_size,
         num_views=opt.num_views, data="lvis", workers=opt.num_workers,
         unet_remat=opt.unet_remat, process_group=main_rec["backend"],
         wrapper=main_rec["wrapper"], batch_shapes=main_rec["batch"],
         steps_s=main_rec["step_s"], step_warm_s=warm,
         train_steps_per_s=1.0 / warm, wait_s=main_rec["wait_s"],
         wait_warm_s=median(main_rec["wait_s"][1:]),
         loop_steps_per_s=6 / sum(main_rec["step_s"] + main_rec["wait_s"]),
         main_s=main_rec["main_s"], loss=main_rec["loss"],
         eval=evals[0], checkpoint=os.path.relpath(main_rec["ckpt"], ROOT),
         checkpoint_gb=os.path.getsize(main_rec["ckpt"]) / 2**30,
         peak_mem_gb=main_rec["peak_mem_gb"],
         launches_per_step=dict(zip(("mha_fwd", "mha_bwd", "composite_fwd",
                                     "composite_bwd"), per_step)),
         launches=main_rec["total_launches"], **k1_routes,
         k1_shape=k1_shape, k1_max_abs_err=k1_err,
         k1_lse_max_abs_err=k1_lse_err,
         k1_bwd_max_abs_err=k1b_err, k1_bwd_tol=k1b_tol,
         k2_bwd_max_abs_err=k2b_err, k2_bwd_max_row_rel_err=k2b_rel)

    zws = os.path.join(ROOT, "build", "smoke", "train_disk_zero1")
    zero = run(zws, 2, ["--zero1", "1"], ())
    per_step, total = expected(zero, 2)
    if (any(l != per_step for l in zero["launches"])
            or zero["total_launches"] != total
            or not np.isfinite(zero["loss"]).all()):
        raise AssertionError(f"train_disk zero1: launches "
                             f"{zero['launches']}, losses {zero['loss']}")
    emit("train_disk_zero1", steps_s=zero["step_s"], wait_s=zero["wait_s"],
         loss=zero["loss"], eval=zero["eval"][0],
         peak_mem_gb=zero["peak_mem_gb"], launches=zero["total_launches"],
         checkpoint_gb=os.path.getsize(zero["ckpt"]) / 2**30)
    shutil.rmtree(zws)
    return main_rec["total_launches"], main_rec["ckpt"]


def phase_infer_cli(dev, root, ckpt):
    """``python -m lgm_tpu_torch.infer big --mv-images`` as a subprocess on
    the card: four input views (1-4) of the first test scene written as
    PNGs, the weights ``train_disk``'s checkpoint; it must exit 0 and
    write the ``.ply`` and the orbit."""
    import glob
    import sys

    import numpy as np

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.io import png
    from lgm_tpu_torch.io.ply import load_ply

    scenes = sorted(glob.glob(os.path.join(root, "00000-09999", "*")))
    scene = scenes[-CONFIGS["big"].batch_size]
    ws = os.path.join(ROOT, "build", "smoke", "infer_cli")
    os.makedirs(ws, exist_ok=True)
    paths = []
    for i in range(4):
        paths.append(os.path.join(ws, f"v{i}.png"))
        png.write(paths[-1], png.read_rgba(os.path.join(
            scene, f"{i + 1:03d}.png"))[0])
    cmd = [sys.executable, "-m", "lgm_tpu_torch.infer", "big",
           "--mv-images", *paths, "--resume", ckpt, "--workspace", ws,
           "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"infer CLI exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    ply = os.path.join(ws, "v0.ply")
    video = [f for f in os.listdir(ws) if f.startswith("v0.")
             and f.endswith((".mp4", ".frames.npy"))]
    g = load_ply(ply)
    if not (len(g) > 0 and np.isfinite(g).all() and video):
        raise AssertionError(f"infer CLI wrote {os.listdir(ws)}")
    frames = None
    if video[0].endswith(".npy"):
        frames = list(np.load(os.path.join(ws, video[0]),
                              mmap_mode="r").shape)
    jpeg_run = infer_jpeg(dev, ckpt, os.path.join(ws, "jpeg"), JPEG_VIEWS)
    progressive_run = infer_jpeg(dev, ckpt, os.path.join(ws, "progressive"),
                                 PROGRESSIVE_VIEWS)
    emit("infer_cli", scene=os.path.relpath(scene, ROOT), wall_s=wall_s,
         ply=os.path.relpath(ply, ROOT), ply_gaussians=len(g),
         video=video[0], frames=frames,
         checkpoint=os.path.relpath(ckpt, ROOT), jpeg=jpeg_run,
         progressive_jpeg=progressive_run)
    os.remove(ckpt)
    return jpeg_run["launches"], progressive_run["launches"]


def infer_jpeg(dev, ckpt, ws, paths):
    """``infer.main(["big", "--mv-images", *paths])`` in this process on
    four committed JPEG views with ``ckpt``: K1 16 and K2 180
    exactly, and the .ply byte for byte that of the array path, the same
    weights' ``forward_gaussians`` on the views decoded here (BGR / 255
    -> RGB, INTER_AREA to the input size), cuDNN's deterministic
    algorithms on for both."""
    import numpy as np
    import torch

    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.io import jpeg
    from lgm_tpu_torch.io.ply import save_ply
    from lgm_tpu_torch.models.unet import MVAttention
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.mha import mha_fwd
    from lgm_tpu_torch.utils.resize import resize

    opt = CONFIGS["big"]
    os.makedirs(ws, exist_ok=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mha_fwd.launches = fs.composite_fwd.launches = 0
        t0 = time.perf_counter()
        infer.main(["big", "--mv-images", *paths, "--resume", ckpt,
                    "--workspace", ws, "--device", dev.type])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        got = {"mha_fwd": mha_fwd.launches,
               "composite_fwd": fs.composite_fwd.launches}
        model = infer.load_model(opt, ckpt, str(dev))
        sites = sum(isinstance(m, MVAttention) for m in model.modules())
        expected = {"mha_fwd": sites, "composite_fwd": 180}
        if got != expected:
            raise AssertionError(f"infer on JPEG views: launches {got}, "
                                 f"expected {expected}")
        views = np.stack([resize(
            jpeg.imread(p).astype(np.float32)[..., [2, 1, 0]] / 255.0,
            (opt.input_size, opt.input_size), "area") for p in paths])
        ref = os.path.join(ws, "array_path.ply")
        save_ply(infer.forward_gaussians(model, views), ref)
        del model
    finally:
        torch.backends.cudnn.deterministic = deterministic
    stem = os.path.splitext(os.path.basename(paths[0]))[0]
    with open(ref, "rb") as a, open(os.path.join(ws, stem + ".ply"),
                                    "rb") as b:
        if a.read() != b.read():
            raise AssertionError("infer on JPEG views: the .ply is not the "
                                 "array path's")
    torch.cuda.empty_cache()
    return dict(wall_s=wall_s, launches=got, ply_equal_array_path=True,
                views=[os.path.relpath(p, ROOT) for p in paths])


# The mesh converter at lgm_tpu's default depth and widths
# (lgm_tpu/convert.py:512-523): its iterations of each stage, the density
# grid and the face target. One K2 launch per teacher view.
CONVERT_ITERS = {"nerf": 512, "mesh": 256, "texture": 128}
CONVERT_GRID, CONVERT_FACES = 192, 50_000
# trirast's candidate cap a tile (lgm_tpu/ops/trirast.py:46).
TRIRAST_CAP = 1024
# rasterize on the card against its CPU path on the same view: the edge
# functions' products may contract to FMAs on the card, so a pixel on an
# edge shared by two faces may go to the other one.
RASTER_EQUAL_SHARE = 0.999
# The viewer's orbit: frames served and their elevation.
VIEWER_FRAMES, VIEWER_EL = 20, 15.0


def method_clock(obj, names):
    """A context in which spies on ``obj``'s methods ``names`` time each
    call from a device synchronize before it to one after it and read the
    peak device memory of the call: yields {name: {"s", "peak_gb"}}."""
    import contextlib
    from unittest import mock

    import torch

    @contextlib.contextmanager
    def clock():
        times = {}

        def timed(fn, name):
            def call(*args, **kw):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                times[name] = {"s": time.perf_counter() - t0,
                               "peak_gb": torch.cuda.max_memory_allocated()
                               / 2**30}
                return out
            return call

        with contextlib.ExitStack() as stack:
            for name in names:
                stack.enter_context(mock.patch.object(
                    obj, name, timed(getattr(obj, name), name)))
            yield times

    return clock()


def phase_convert(dev):
    """The mesh converter as ``python -m lgm_tpu_torch.convert big`` runs
    it, at lgm_tpu's default depth and widths, on the bench scene's 65,536
    splats (seeded: LGM big with random weights makes noise): fit_nerf 512
    iterations at 128², extract_mesh at 192³ to 50,000 faces, fit_mesh 256
    at 256², the chart unwrap, fit_texture 128 at 256² into 1024², the
    .glb. Each stage timed by spies (``method_clock``); K2's launches
    counted (one a teacher view, 896); K2 on the first teacher render at
    128² and at 256² against its plain version (the same bits again, and
    within K2_ATOL), timed; fit_mesh's first rasterization: the candidate
    cap's reach, and the same view rasterized on the CPU; the .glb read
    back."""
    from unittest import mock

    import numpy as np
    import torch

    from lgm_tpu_torch import convert
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.io.mesh import load_glb
    from lgm_tpu_torch.ops import trirast
    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    g = sample_scene(np.random.default_rng(0), 65536)
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    out_path = os.path.join(work, "convert.glb")

    teacher, rast = {}, {}
    composite, rasterize = fs.composite, trirast.rasterize

    def composite_spy(params, counts, tile_h, tile_w, tiles_x):
        out = composite(params, counts, tile_h, tile_w, tiles_x)
        teacher.setdefault(tile_w * tiles_x, (params, counts, tile_h,
                                              tile_w, tiles_x, out))
        return out

    def rasterize_spy(clip, faces, image_size, **kw):
        out = rasterize(clip, faces, image_size, **kw)
        rast.setdefault("first", (clip.detach(), faces, image_size, kw, out))
        return out

    stages = ("fit_nerf", "extract_mesh", "fit_mesh", "unwrap_uv",
              "fit_texture", "export")
    t0 = time.perf_counter()
    conv = convert.Converter(CONFIGS["big"], g, seed=0, device=str(dev))
    fs.composite_fwd.launches = 0
    with method_clock(conv, stages) as times, \
            mock.patch.object(fs, "composite", composite_spy), \
            mock.patch.object(trirast, "rasterize", rasterize_spy):
        conv.run(out_path, nerf_iters=CONVERT_ITERS["nerf"],
                 mesh_iters=CONVERT_ITERS["mesh"],
                 tex_iters=CONVERT_ITERS["texture"],
                 grid_resolution=CONVERT_GRID, target_faces=CONVERT_FACES)
    wall_s = time.perf_counter() - t0
    launches = fs.composite_fwd.launches
    expected = sum(CONVERT_ITERS.values())
    if launches != expected:
        raise AssertionError(f"K2 launches {launches}, expected {expected}")

    # K2 on the first teacher render of each size.
    k2 = {}
    with torch.inference_mode():
        for S, (params, counts, th, tw, tiles_x, out) in sorted(
                teacher.items()):
            args = (params, counts, th, tw, tiles_x)
            again = fs.composite_fwd(*args)
            ref = fs.composite_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(again, out):
                raise AssertionError(f"K2 teacher {S}²: two runs differ")
            err = float((out - ref).abs().max())
            if not err <= K2_ATOL:
                raise AssertionError(f"K2 teacher {S}²: max abs err {err}")
            w = fs.composite_work(*args)
            b_ms, b_by = k2_bound(w, params.shape[2], counts, S)
            k2[S] = dict(
                image=S, tiles=int(params.shape[0]),
                slots_total=int(counts.sum()), live_pairs=w["pairs"],
                used_pairs=w["used"], max_abs_err=err, bitwise_repeat=True,
                ms=cuda_ms(lambda: fs.composite_fwd(*args),
                           launches=K1_LAUNCHES),
                one_call_ms=cuda_ms(lambda: fs.composite_fwd(*args)),
                plain_ms=cuda_ms(lambda: fs.composite_reference(*args),
                                 reps=5),
                bound_ms=b_ms, bound_by=b_by)
    emit("convert_k2", teacher=list(k2.values()), tol=K2_ATOL)

    # fit_mesh's first view: the candidate cap, and the CPU path.
    clip, faces, S, kw, out = rast["first"]
    cap = kw.get("max_faces_per_tile", TRIRAST_CAP)
    tile_faces = out["tile_faces"]
    cpu = trirast.rasterize(clip.cpu(), faces.cpu(), S, **kw)
    fid = out["face_id"].cpu()
    same = fid == cpu["face_id"]
    share = float(same.float().mean())
    bary_err = float((out["bary"].cpu() - cpu["bary"])[same].abs().max())
    if share < RASTER_EQUAL_SHARE:
        raise AssertionError(f"rasterize on the card vs CPU: {share} of "
                             f"face ids equal < {RASTER_EQUAL_SHARE}")
    emit("convert_trirast", image=S, faces=int(faces.shape[0]),
         max_faces_per_tile=cap,
         tile_candidates_max=int(tile_faces.max()),
         tile_candidates_mean=float(tile_faces.float().mean()),
         tiles_over_cap=int((tile_faces > cap).sum()),
         candidates_dropped=int((tile_faces - cap).clamp_min(0).sum()),
         covered_share=float((fid >= 0).float().mean()),
         face_id_equal_share=share, bary_max_abs_err_where_equal=bary_err,
         cpu_tile_candidates_equal=bool(torch.equal(
             tile_faces.cpu(), cpu["tile_faces"])))

    verts, faces_r, uv, tex = load_glb(out_path)
    if not (len(verts) == len(conv.verts) and len(faces_r) == len(conv.faces)
            and uv is not None and len(uv) == len(conv.uv)
            and tex[:8] == b"\x89PNG\r\n\x1a\n"):
        raise AssertionError("the .glb read back differs from the mesh")
    losses = {k: [v[0], v[-1]] for k, v in conv.losses.items()}
    if not all(np.isfinite(v).all() for v in conv.losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    emit("convert", splats=len(g), iters=CONVERT_ITERS,
         grid_resolution=CONVERT_GRID, target_faces=CONVERT_FACES,
         tex_size=int(conv.texture.shape[0]), wall_s=wall_s,
         stages=times, loss_first_last=losses, verts=len(conv.verts),
         faces=len(conv.faces), n_charts=conv.n_charts,
         glb_mb=os.path.getsize(out_path) / 2**20,
         glb=os.path.relpath(out_path, ROOT), k2_launches=launches)
    return {"composite_fwd": launches}, k2


def phase_convert_cli(dev):
    """``python -m lgm_tpu_torch.convert big --test-path x.ply`` in a
    subprocess on the card: the bench scene written with ``save_ply``, the
    depth cut (32 / 16 / 8 iterations; ``convert`` runs the full depth);
    the .glb must load."""
    import sys

    import numpy as np

    from lgm_tpu_torch.data.synthetic import sample_scene
    from lgm_tpu_torch.io.mesh import load_glb
    from lgm_tpu_torch.io.ply import save_ply

    ws = os.path.join(ROOT, "build", "smoke", "convert_cli")
    os.makedirs(ws, exist_ok=True)
    ply, glb = os.path.join(ws, "scene.ply"), os.path.join(ws, "scene.glb")
    save_ply(sample_scene(np.random.default_rng(0), 65536)[None], ply)
    cmd = [sys.executable, "-m", "lgm_tpu_torch.convert", "big",
           "--test-path", ply, "--out", glb, "--nerf-iters", "32",
           "--mesh-iters", "16", "--tex-iters", "8", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"convert CLI exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    verts, faces, uv, tex = load_glb(glb)
    if not (len(faces) > 0 and uv is not None
            and tex[:8] == b"\x89PNG\r\n\x1a\n"):
        raise AssertionError("convert CLI: the .glb does not load")
    emit("convert_cli", wall_s=wall_s, verts=len(verts), faces=len(faces),
         glb=os.path.relpath(glb, ROOT), iters=[32, 16, 8])


# convert_quality's sanity bounds at the quick budget: an order of
# magnitude around lgm_tpu's default-budget torus (chamfer 0.061, 18.4 dB;
# benchmarks/convert_quality_torus.jsonl), enough to catch a broken
# stage. The reference-budget rows are held to lgm_tpu's in quality/.
QUICK_CHAMFER_MAX, QUICK_PSNR_MIN = 0.1, 12.0


def phase_convert_quality(dev):
    """``scripts/eval_convert_quality_torch.py`` at its quick budget
    (128 / 96 / 64 iterations, 128 grid) on the torus of 6,000 Gaussians:
    chamfer against the analytic surface, PSNR of the textured mesh
    against the Gaussian renders at 4 held-out poses, and seconds; K2
    launched for the teacher views."""
    import importlib.util

    import numpy as np

    from lgm_tpu_torch.ops.gsplat import flatsort as fs

    spec = importlib.util.spec_from_file_location(
        "eval_convert_quality_torch",
        os.path.join(ROOT, "scripts", "eval_convert_quality_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fs.composite_fwd.launches = 0
    t0 = time.perf_counter()
    row = script.evaluate("torus", "quick", device=str(dev))
    wall_s = time.perf_counter() - t0
    launches = fs.composite_fwd.launches
    if not (row["n_faces"] > 0 and launches > 0
            and np.isfinite([row["chamfer"], row["psnr_mesh_vs_gs"]]).all()
            and row["chamfer"] < QUICK_CHAMFER_MAX
            and row["psnr_mesh_vs_gs"] > QUICK_PSNR_MIN):
        raise AssertionError(f"convert_quality: {row}, K2 {launches}")
    emit("convert_quality", wall_s=wall_s, k2_launches=launches,
         chamfer_max=QUICK_CHAMFER_MAX, psnr_min=QUICK_PSNR_MIN, **row)
    return {"composite_fwd": launches}


def _get(url, timeout=120):
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read()
        return body, dict(r.headers), (time.perf_counter() - t0) * 1e3


def phase_viewer_http(dev):
    """The splat viewer serving the bench scene at 512² on a free port in
    a thread: the page, 20 frames around an orbit and one each of alpha and
    depth, K2 once a frame exactly; X-Render-Ms and the round trip; one
    served frame against ``render_views``' own output for its camera,
    quantised as the viewer does (PNG: its pixels bit for bit; JPEG: the
    bytes cv2 makes of them, bit for bit)."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from lgm_tpu_torch.apps import viewer
    from lgm_tpu_torch.io import png
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.gsplat.api import render_views
    from lgm_tpu_torch.utils import camera

    g, _ = bench_scene(dev)
    state = viewer.ViewerState(g.cpu().numpy(), size=512, device=str(dev))
    port = free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                viewer._make_handler(state))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        page, _, _ = _get(url + "/")
        if b"X-Render-Ms" not in page:
            raise AssertionError("viewer page")
        queries = [f"/render?el={VIEWER_EL}&az={az}&radius=1.5&fovy=49.1"
                   for az in np.linspace(0, 360, VIEWER_FRAMES,
                                         endpoint=False)]
        queries += [queries[3] + "&mode=alpha", queries[3] + "&mode=depth"]
        _get(url + queries[0])  # warm
        fs.composite_fwd.launches = 0
        render_ms, trip_ms, served = [], [], []
        for q in queries:
            body, headers, ms = _get(url + q)
            render_ms.append(float(headers["X-Render-Ms"]))
            trip_ms.append(ms)
            served.append((body, headers["Content-Type"]))
        launches = fs.composite_fwd.launches
    finally:
        httpd.shutdown()
        thread.join()
    if launches != len(queries):
        raise AssertionError(f"viewer: K2 {launches} for {len(queries)} "
                             "frames")
    # Frame 3 against render_views for its camera.
    az = float(np.linspace(0, 360, VIEWER_FRAMES, endpoint=False)[3])
    cams = camera.build_camera_inputs(
        camera.orbit_camera(VIEWER_EL, az, 1.5)[None], 49.1, 0.5, 2.5)
    tan = float(np.tan(0.5 * np.deg2rad(49.1)))
    with torch.inference_mode():
        img = render_views(g[None], torch.as_tensor(
            cams["cam_view"], device=dev)[None], 512, tan, dup=32)[
            "image"][0, 0].cpu().numpy()
    q8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    body, ctype = served[3]
    if ctype == "image/png":
        if not np.array_equal(png.decode_rgba(body)[0][..., :3], q8):
            raise AssertionError("viewer: the served PNG differs")
        jpeg_mean_err = None
    else:
        import cv2

        ok, ref = cv2.imencode(".jpg", q8[..., ::-1])
        if not (ok and body == ref.tobytes()):
            raise AssertionError("viewer: the served JPEG differs")
        dec = cv2.imdecode(np.frombuffer(body, np.uint8),
                           cv2.IMREAD_COLOR)[..., ::-1]
        jpeg_mean_err = float(np.abs(dec.astype(int) - q8).mean())
    frame_ms = render_ms[:VIEWER_FRAMES]
    emit("viewer_http", size=512, splats=int(g.shape[0]),
         frames=len(queries), content_type=ctype,
         k2_launches=launches, render_ms_median=median(frame_ms),
         render_ms_min=min(frame_ms), render_ms_max=max(frame_ms),
         round_trip_ms_median=median(trip_ms[:VIEWER_FRAMES]),
         round_trip_ms_min=min(trip_ms[:VIEWER_FRAMES]),
         round_trip_ms_max=max(trip_ms[:VIEWER_FRAMES]),
         alpha_depth_render_ms=render_ms[VIEWER_FRAMES:],
         served_frame_equal=True, jpeg_mean_abs_err_255=jpeg_mean_err)
    return {"composite_fwd": launches / len(queries)}


def phase_app_http(dev):
    """The serving app at LGM ``big`` (seeded weights) on a free port in a
    thread: four 256² RGBA PNG views POSTed as multipart twice (cold, then
    warm), then the four committed 256² JPEG views, K1 16 and K2 180 a
    request exactly; the links followed: the
    served .ply is, byte for byte, the .ply of ``infer.forward_gaussians``
    on the same decoded views (cuDNN's deterministic algorithms on for the
    phase, so two forwards give the same bits), and the orbit is there."""
    import shutil
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from lgm_tpu_torch import infer
    from lgm_tpu_torch.apps import app
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.io import png
    from lgm_tpu_torch.io.ply import save_ply
    from lgm_tpu_torch.models.unet import MVAttention
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.mha import mha_fwd

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    opt = CONFIGS["big"]
    t0 = time.perf_counter()
    state = app.AppState(opt, resume=None, device=str(dev))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sites = sum(isinstance(m, MVAttention) for m in state.model.modules())
    expected = {"mha_fwd": sites, "composite_fwd": 180}
    port = free_port()
    httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                app._make_stdlib_handler(state))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    requests, counts = [], []
    try:
        for seed in (3, 4, "jpeg"):
            if seed == "jpeg":
                ext, parts = "jpg", []
                for path in JPEG_VIEWS:
                    with open(path, "rb") as fh:
                        parts.append(fh.read())
            else:
                ext = "png"
                parts = [png.encode(v) for v in rgba_views(
                    dev, seed, 4, 256, [0.0] * 4, [0.0, 90.0, 180.0, 270.0])]
            boundary = "lgmsmokeboundary"
            body = b"".join(
                f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="v{i}"; filename="v{i}.{ext}"\r\n'
                f"Content-Type: image/{ext}\r\n\r\n".encode()
                + data + b"\r\n" for i, data in enumerate(parts))
            body += f"--{boundary}--\r\n".encode()
            req = urllib.request.Request(
                url + "/mv", data=body, method="POST", headers={
                    "Content-Type":
                    f"multipart/form-data; boundary={boundary}"})
            mha_fwd.launches = fs.composite_fwd.launches = 0
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                reply = r.read().decode()
            wall_s = time.perf_counter() - t0
            got = {"mha_fwd": mha_fwd.launches,
                   "composite_fwd": fs.composite_fwd.launches}
            if got != expected or "done" not in reply:
                raise AssertionError(f"app: launches {got}, expected "
                                     f"{expected}; reply {reply[:300]}")
            links = [part.split('"')[0] for part in
                     reply.split('href="')[1:]]
            ply, _, _ = _get(url + links[0])
            video, _, video_ms = _get(url + links[1], timeout=600)
            mv = np.stack([app.decode_view(data, f"v{i}", opt.input_size)
                           for i, data in enumerate(parts)])
            ref_path = os.path.join(state.workdir, "expected.ply")
            save_ply(infer.forward_gaussians(state.model, mv), ref_path)
            with open(ref_path, "rb") as fh:
                if fh.read() != ply:
                    raise AssertionError("app: the served .ply is not the "
                                         "forward's of the decoded views")
            requests.append(dict(wall_s=wall_s, ply_mb=len(ply) / 2**20,
                                 video=links[1], video_mb=len(video) / 2**20,
                                 video_fetch_ms=video_ms))
            counts.append(got)
    finally:
        httpd.shutdown()
        thread.join()
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(state.workdir)
    emit("app_http", preset="big", load_s=load_s, cold=requests[0],
         warm=requests[1], jpeg=requests[2], launches_per_request=counts,
         ply_equal_forward=True,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    del state
    torch.cuda.empty_cache()
    return counts[-1]


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
    # Each named range (SCOPES) as a span of the device timeline, from its
    # first kernel's start to its last one's end, idle included.
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
    ptxas = phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev, ptxas)
    projection = phase_projection(dev)
    k1b = phase_k1_bwd(dev)
    vp_fwd, vp_bwd = phase_vp_kernels(dev)
    k1f, k1bf, k1f_split = phase_k1_f32(dev, ptxas)
    k2b = phase_k2_bwd(dev)
    k3, k3_args, k3_out, k3_work = phase_k3(dev, ptxas)
    k3b = phase_k3_bwd(dev, k3_args, k3_out, k3_work)
    del k3_args, k3_out
    k1_diffusion = phase_k1_diffusion(dev)
    k1_train_shapes, k1b_train_shapes = phase_k1_bwd_diffusion(dev)
    infer_launches, model, mv, gaussians = phase_main(dev)
    phase_profile(dev, model, mv, gaussians)
    phase_orbit_devices(dev, gaussians)
    text_launches = phase_diffusion_text(dev)
    image_launches = phase_image_to_3d(dev, model)
    del model
    torch.cuda.empty_cache()
    launches = phase_train(dev)
    torch.cuda.empty_cache()
    fp32_launches = phase_fp32(dev, mv)
    torch.cuda.empty_cache()
    v1_launches = phase_train_v1(dev)
    torch.cuda.empty_cache()
    phase_v1_image(dev)
    phase_nano(dev)
    phase_bridge(dev)
    torch.cuda.empty_cache()
    finetune_launches = {name: phase_diffusion_train(dev, name)
                         for name in ("mvdream", "imagedream")}
    phase_png_codec(dev)
    phase_jpeg_codec()
    root = phase_disk_dataset(dev)
    phase_loader(dev, root)
    disk_launches, ckpt = phase_train_disk(dev, root)
    torch.cuda.empty_cache()
    infer_jpeg_launches, progressive_launches = phase_infer_cli(dev, root,
                                                                ckpt)
    phase_diffusion_train_cli(dev, root)
    torch.cuda.empty_cache()
    convert_launches, _ = phase_convert(dev)
    torch.cuda.empty_cache()
    phase_convert_cli(dev)
    quality_launches = phase_convert_quality(dev)
    torch.cuda.empty_cache()
    viewer_launches = phase_viewer_http(dev)
    app_launches = phase_app_http(dev)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        dict(name="mha_fwd", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_fwd_wgmma.cu",
             image_to_3d_route_launches=image_launches["mha_fwd_routes"],
             replaces="lgm_tpu/ops/mha.py:42", launches=launches["mha_fwd"],
             infer_launches=infer_launches["mha_fwd"],
             diffusion_text_launches=text_launches["mha_fwd"],
             image_to_3d_launches=image_launches["mha_fwd"],
             diffusion_shapes=k1_diffusion,
             diffusion_train_shapes=k1_train_shapes,
             app_launches_per_request=app_launches["mha_fwd"],
             infer_jpeg_launches=infer_jpeg_launches["mha_fwd"],
             infer_progressive_jpeg_launches=progressive_launches["mha_fwd"],
             vp_shapes=vp_fwd, **{k: k1[k] for k in keys}),
        dict(name="composite_fwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/composite_fwd.cu",
             replaces="lgm_tpu/ops/gsplat/flatsort.py:462",
             launches=launches["composite_fwd"],
             infer_launches=infer_launches["composite_fwd"],
             image_to_3d_launches=image_launches["composite_fwd"],
             convert_launches=convert_launches["composite_fwd"],
             viewer_launches_per_frame=viewer_launches["composite_fwd"],
             app_launches_per_request=app_launches["composite_fwd"],
             infer_jpeg_launches=infer_jpeg_launches["composite_fwd"],
             infer_progressive_jpeg_launches=progressive_launches[
                 "composite_fwd"],
             convert_quality_launches=quality_launches["composite_fwd"],
             **{k: k2[k] for k in keys}),
        dict(name="mha_bwd", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_bwd_wgmma.cu",
             replaces="lgm_tpu/ops/mha.py:61", launches=launches["mha_bwd"],
             diffusion_shapes_bwd=k1b_train_shapes, vp_shapes=vp_bwd,
             **{k: k1b[k] for k in keys}),
        dict(name="composite_bwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/composite_bwd.cu",
             replaces="lgm_tpu/ops/gsplat/flatsort.py:514",
             launches=launches["composite_bwd"],
             **{k: k2b[k] for k in keys}),
        dict(name="tile_composite_fwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/tiled_fwd.cu",
             replaces="lgm_tpu/ops/gsplat/tiled.py:240",
             launches=v1_launches["tile_composite_fwd"],
             **{k: k3[k] for k in keys}),
        dict(name="tile_composite_bwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/tiled_bwd.cu",
             replaces="lgm_tpu/ops/gsplat/tiled.py:286",
             launches=v1_launches["tile_composite_bwd"],
             **{k: k3b[k] for k in keys}),
        # K1 and K1ᵇ on f32 inputs: launches of the fp32 bs2 steps (phase
        # fp32_train), the fp32 inference and the bs 8 step beside them;
        # the numbers of a B = 1 forward's sites (K1) and a bs2 step's
        # (K1ᵇ), as the bf16 entries.
        dict(name="mha_fwd_f32", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_fwd_f32.cu",
             replaces="lgm_tpu/ops/mha.py:42",
             launches=fp32_launches["train"]["mha_fwd_f32"],
             infer_launches=fp32_launches["infer"]["mha_fwd_f32"],
             train_bs8_launches=fp32_launches["train_bs8"]["mha_fwd_f32"],
             shapes=k1f["shapes"], vp_shapes=k1f["vp_shapes"],
             **{k: k1f[k] for k in keys}),
        dict(name="mha_bwd_f32", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_bwd_f32.cu",
             replaces="lgm_tpu/ops/mha.py:61",
             launches=fp32_launches["train"]["mha_bwd_f32"],
             train_bs8_launches=fp32_launches["train_bs8"]["mha_bwd_f32"],
             vp_shapes=k1bf["vp_shapes"], **{k: k1bf[k] for k in keys}),
        # The f32 kernels' operand split (no TPU kernel of its own: it
        # serves K1 and K1ᵇ on f32 inputs, whose TPU kernels it names),
        # launched once before each: its numbers are those of a bs2 fp32
        # step's 32 launches (16 in K1, 16 in K1ᵇ), inside their ms.
        dict(name="mha_split_tf32", route="cuda",
             source="lgm_tpu_torch/ops/csrc/mha_split_tf32.cu",
             replaces="lgm_tpu/ops/mha.py:42 and :61 (operand split of the "
                      "f32 K1 and K1ᵇ; no TPU kernel of its own)",
             launches=fp32_launches["train"]["mha_split_tf32"],
             infer_launches=fp32_launches["infer"]["mha_split_tf32"],
             train_bs8_launches=fp32_launches["train_bs8"]["mha_split_tf32"],
             **{k: k1f_split[k] for k in keys}),
        # The projection kernels (no TPU kernel of their own: lgm_tpu fuses
        # project_gaussians under jit): the forward's numbers on the bench
        # view (R = 10), the backward's on the train camera (R = 9).
        dict(name="project_fwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/project_fwd.cu",
             replaces="lgm_tpu/ops/gsplat/projection.py::project_gaussians "
                      "(fused by XLA; no TPU kernel of its own)",
             launches=launches["project_fwd"],
             **{k: projection["bench"][k] for k in keys}),
        dict(name="project_bwd", route="cuda",
             source="lgm_tpu_torch/ops/gsplat/csrc/project_bwd.cu",
             replaces="the VJP of lgm_tpu/ops/gsplat/projection.py::"
                      "project_gaussians (no TPU kernel of its own)",
             launches=launches["project_bwd"], library_ms=None,
             max_abs_err=projection["train"]["bwd"]["max_col_err"],
             **{k: projection["train"]["bwd"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by")}),
    ]
    # The pallas_v1 training path's own counts of the kernels it shares
    # with the other two paths.
    for kernel in kernels[:4]:
        kernel["train_v1_launches"] = v1_launches[kernel["name"]]
        kernel["train_disk_launches"] = disk_launches[kernel["name"]]
    # The finetune phases' counts (6 steps each) of the kernels they run.
    for kernel in kernels[:3]:
        kernel["diffusion_train_launches"] = {
            name: counts[kernel["name"]]
            for name, counts in finetune_launches.items()}
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
