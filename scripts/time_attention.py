#!/usr/bin/env python3
"""Device times of K1 and K1ᵇ at every row the port runs them, for any
checkout: ``chip_smoke.py``'s phases ``k1`` (LGM big at B = 1 and bs2,
with the row statistic), ``k1_bwd`` (bs2), ``vp_kernels`` (a vp rank's
lengths), ``k1_diffusion`` (the diffusion U-Net's level 0 at inference,
``K1_DIFFUSION_SHAPES``) and ``k1_bwd_diffusion`` (the finetune's,
``K1_TRAIN_SHAPES``) and ``k1_f32`` (K1 and K1ᵇ on f32 inputs at
``K1_F32_SHAPES``, vp rows included), run from the tree at ``--root``
with that tree's kernels, then one summary line. ``--only f32`` runs the
f32 phase alone. To
compare two commits on one card, run it for each in one call, in turns
(old, new, new, old), the older one an unpacked ``git archive`` in a
directory ``.gitignore`` lists:

    python3 scripts/time_attention.py --root build/parent --tag parent
    python3 scripts/time_attention.py --tag change

``--end-to-end`` then also runs the phases ``main``, ``image_to_3d``,
``diffusion_train`` (MVDream, ImageDream) and ``train`` (LGM big bs2) of
that tree, whose lines carry ``forward_warm_s``, ``denoise_s`` and the
finetune's and the LGM step's ``step_warm_s``.

Prints each phase's JSON lines and ``{"tag": ..., "k1_forward_ms": ...,
"k1b_step_ms": ..., "vp_ms": [...], "k1_diffusion_ms": {...},
"k1_train_ms": {...}, "k1b_train_ms": {...}, "k1_f32_forward_ms": ...,
"k1b_f32_step_ms": ..., "f32_ms": [...], "f32_vp_ms": [...]}`` (K1 over
the 16 sites of a B = 1 forward, K1ᵇ over those of a bs2 step, [BH, S,
D, vp, K1 ms, K1ᵇ ms] at rank 0's lengths, and one call at each
diffusion row by model; the f32 K1 over a B = 1 forward's sites and K1ᵇ
over a bs2 step's, [BH, S, D, K1 ms, K1ᵇ ms] at each f32 row and [BH, S,
D, vp, K1 ms, K1ᵇ ms] at each f32 vp row; the bf16 keys are absent with
``--only f32``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--end-to-end", action="store_true")
    ap.add_argument("--only", choices=("f32",), default=None)
    ns = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(ns.root)
    sys.path.insert(0, root)
    import chip_smoke

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != root:
        raise RuntimeError(f"chip_smoke imported from outside {root}")
    from lgm_tpu_torch.ops import _build

    libs = _build.build([name for name in _build.sources()
                         if name.startswith("mha_")])
    # ptxas reports of this tree's attention libraries (phase k1_f32 prints
    # the f32 ones).
    ptxas = {name: chip_smoke.ptxas_summary(
        so.with_name(so.name + ".log").read_text())
        for name, so in libs.items()}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    summary = {"tag": ns.tag, "root": root}
    if ns.only is None:
        k1 = chip_smoke.phase_k1(dev)
        k1b = chip_smoke.phase_k1_bwd(dev)
        vp_fwd, vp_bwd = chip_smoke.phase_vp_kernels(dev)
        diffusion = chip_smoke.phase_k1_diffusion(dev)
        train_fwd, train_bwd = chip_smoke.phase_k1_bwd_diffusion(dev)
        summary.update({
            "k1_forward_ms": k1["ms"], "k1b_step_ms": k1b["ms"],
            "vp_ms": [[*f["shape"], f["vp"], f["ms"], b["ms"]]
                      for f, b in zip(vp_fwd, vp_bwd)],
            "k1_diffusion_ms": {m: r["ms"] for m, r in diffusion.items()},
            "k1_train_ms": {m: r["ms"] for m, r in train_fwd.items()},
            "k1b_train_ms": {m: r["ms"] for m, r in train_bwd.items()}})
    # An older tree's phase returns (K1, K1ᵇ); a newer one the split too.
    f32 = chip_smoke.phase_k1_f32(dev, ptxas)
    k1f, k1bf = f32[0], f32[1]
    summary.update({
        "k1_f32_forward_ms": k1f["ms"], "k1b_f32_step_ms": k1bf["ms"],
        "f32_ms": [[*r["shape"], r["k1_ms"], r["k1b_ms"]]
                   for r in k1f["shapes"]],
        "f32_vp_ms": [[*f["shape"], f["vp"], f["ms"], b["ms"]]
                      for f, b in zip(k1f["vp_shapes"], k1bf["vp_shapes"])]})
    print(json.dumps(summary), flush=True)
    if ns.end_to_end:
        _, model, _, _ = chip_smoke.phase_main(dev)
        chip_smoke.phase_image_to_3d(dev, model)
        del model
        torch.cuda.empty_cache()
        for name in ("mvdream", "imagedream"):
            chip_smoke.phase_diffusion_train(dev, name)
            torch.cuda.empty_cache()
        chip_smoke.phase_train(dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
