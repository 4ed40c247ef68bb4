"""Readings that the image cell's output-check limits are set from, on the
card at the cell's own size (not part of a benchmark run).

    python3 portbench/calibrate_image.py --seeds <n> [<n> ...] \
        [--control N] [--seconds S]
    python3 portbench/calibrate_image.py --seeds <n> ... \
        --verdict view|eps [--seconds S]

For every seed: the sound program's numbers against the f32 references
(the lower reading). For the first ``--control`` seeds also: the control,
the references a step below each stated precision in the program's place
(bf16 CLIP towers, fp8 U-Net, VAE and LGM, the renderer in bf16); and
two faults read on the program's own outputs, one view's colour
channels reversed (``view``) and ε scaled by 1.1 (``eps``). One JSON
line a seed on standard output.

With ``--verdict`` each seed is instead a whole run of the cell
(``harness.run_cell``, a window of ``--seconds``) with the fault planted
in the timed path (``view``: ``infer.image_to_views`` returns view 0 with
its colour channels reversed; ``eps``: the U-Net's ε scaled by 1.1), and
the line gives the run's own ``correct`` and the numbers it compared.
``portbench/calibrate.py --verdict control`` runs the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

CELL = "imagedream-lgm-big.image-to-3d"
EPS_SCALE = 1.1


def plant(fault: str):
    """Plant ``fault`` in the program; returns the function that undoes
    it."""
    from lgm_tpu_torch import infer
    from lgm_tpu_torch.diffusion import mv_unet

    if fault == "view":
        real = infer.image_to_views

        def altered(*a, **k):
            views = real(*a, **k)
            views[0] = views[0][..., ::-1]
            return views
        infer.image_to_views = altered
        return lambda: setattr(infer, "image_to_views", real)
    if fault == "eps":
        real = mv_unet.MultiViewUNetModel.forward

        def scaled(self, *a, **k):
            return real(self, *a, **k) * EPS_SCALE
        mv_unet.MultiViewUNetModel.forward = scaled
        return lambda: setattr(mv_unet.MultiViewUNetModel, "forward", real)
    raise ValueError(fault)


def verdict(seed: int, fault: str, seconds: float, **sizes) -> dict:
    """A whole run of the cell with ``fault`` planted in the timed path.
    ``sizes``: ``run_cell``'s ``device``, ``options`` and ``traffic``."""
    from portbench import harness

    undo = plant(fault)
    try:
        result = harness.run_cell(CELL, seed, seconds, False, time.time(),
                                  **sizes)
    finally:
        undo()
    return {"seed": seed, "verdict": fault, "correct": result["correct"],
            "checks": result["checks"]}


def one_seed(seed: int, control: bool, seconds: float, device="cuda",
             options=None, traffic=None) -> dict:
    import numpy as np

    from portbench import harness
    from portbench.traffic import image

    ctx = harness.build_context(CELL, seed, device, options, traffic)
    cell = image.Cell(ctx)
    t0 = time.time()
    cell.setup()
    out = {"seed": seed, "setup_s": time.time() - t0}
    win = cell.window(seconds)
    out["images"] = win.units
    out["image_s"] = win.seconds / win.units
    picks = cell.sample()
    made = [cell.made(i) for i in picks]
    cell.release()
    want = [cell.stages(i) for i in picks]
    out["program"] = image.compare(made, want)
    out["view_range"] = [[float(np.min(m["views"])), float(np.max(
        m["views"]))] for m in made]
    if control:
        out["control"] = image.compare([cell.stages(i, "control")
                                        for i in picks], want)
        views = []
        for m in made:
            alt = np.concatenate([m["views"][:1, ..., ::-1], m["views"][1:]])
            views.append(dict(m, views=alt, trajectory=alt))
        out["view_altered"] = image.compare(views, want)
        eps = [dict(m, eps=m["eps"] * EPS_SCALE) for m in made]
        out["eps_scaled"] = image.compare(eps, want)
    out["wall_s"] = time.time() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--verdict", choices=("view", "eps"), default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_image: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        if args.verdict:
            out = verdict(seed, args.verdict, args.seconds)
        else:
            out = one_seed(seed, i < args.control, args.seconds)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
