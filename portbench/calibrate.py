"""Readings that a cell's output-check limits are set from, on the card at
the cell's own size (not part of a benchmark run).

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \
        [--control N] [--seconds S]
    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... \
        --verdict control|half [--seconds S]

For every seed: the sound program's numbers against the f32 reference
(the lower reading). For the first ``--control`` seeds also: the control,
the reference in fp8 put in the program's place (the upper reading), and
each fault the cell can have, planted in the program: for ``train`` a
step on half of the batch (the mean over the rest); for ``object`` an
answer altered where it is produced (the Gaussians' colour channels
reversed). A step that leaves the state unchanged reads 1 by its measure
and needs no run. One JSON line a seed on standard output.

With ``--verdict`` each seed is instead a whole run of the cell
(``harness.run_cell``, a window of ``--seconds``) with the control in the
program's place or the fault planted, and the line gives the run's own
``correct`` and the numbers it compared.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def half_batch(real):
    """``train.train_step`` on the first half of the batch only."""
    def half(state, data, bg):
        n = data["input"].shape[0] // 2
        return real(state, {k: v[:n] for k, v in data.items()}, bg)
    return half


def train_fault(cell) -> dict:
    """The program's numbers with each step on the first half of the
    batch, from the cell's own weights and batches."""
    from lgm_tpu_torch import train as prog

    real = prog.train_step
    prog.train_step = half_batch(real)
    try:
        cell.prog = prog
        cell.state = prog.create_state(cell.opt, cell.dev)
        cell.state.model.load_state_dict(cell.w)
        readings = cell._first_steps(cell.ctx.traffic["check_steps"])
    finally:
        prog.train_step = real
        cell.release()
    return readings


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The leaves with the largest gaps, (name, program, reference)."""
    out = {}
    for key in ("grad", "change"):
        ranked = sorted(ref[key], key=lambda k: -abs(prog[key][k] - ref[key][k])
                        / max(ref[key][k], 1e-30))
        out[key] = [(k, prog[key][k], ref[key][k]) for k in ranked[:n]]
    out["losses"] = [prog["losses"], ref["losses"]]
    return out


def verdict(name: str, seed: int, fault: str, seconds: float,
            **sizes) -> dict:
    """A whole run of the cell with the control in the program's place
    (``control``) or a fault planted in the timed path (``half``: each
    step on half of the batch). ``sizes``: ``run_cell``'s ``device``,
    ``options`` and ``traffic``."""
    from lgm_tpu_torch import train

    from portbench import harness

    undo = []
    if fault == "control":
        real_module = harness.traffic_module

        def with_control(mix):
            mod = real_module(mix)
            mod.Cell.check = mod.Cell.control_check
            return mod
        harness.traffic_module = with_control
        undo.append(lambda: setattr(harness, "traffic_module", real_module))
    elif fault == "half":
        real_step = train.train_step
        train.train_step = half_batch(real_step)
        undo.append(lambda: setattr(train, "train_step", real_step))
    else:
        raise ValueError(fault)
    try:
        result = harness.run_cell(name, seed, seconds, False, time.time(),
                                  **sizes)
    finally:
        for f in undo:
            f()
    return {"seed": seed, "verdict": fault, "correct": result["correct"],
            "checks": result["checks"]}


def one_seed(name: str, seed: int, control: bool, seconds: float,
             device: str = "cuda", options=None, traffic=None) -> dict:
    import numpy as np

    from portbench import harness

    ctx = harness.build_context(name, seed, device, options, traffic)
    mod = harness.traffic_module(ctx.mix)
    cell = mod.Cell(ctx)
    t0 = time.time()
    cell.setup()
    out = {"seed": seed, "setup_s": time.time() - t0}
    if ctx.traffic.get("check_steps"):           # the train mix
        cell.release()
        ref = cell.reference()
        out["program"] = mod.compare(cell.readings, ref)
        out["program_worst"] = worst_leaves(cell.readings, ref)
        out["raw"] = {"program": cell.readings, "reference": ref}
        if control:
            ctl = cell.reference("control")
            out["control"] = mod.compare(ctl, ref)
            out["control_worst"] = worst_leaves(ctl, ref)
            half = train_fault(cell)
            out["half_batch"] = mod.compare(half, ref)
            out["raw"].update(control=ctl, half_batch=half)
    else:                                        # the object mix
        win = cell.window(seconds)
        out["objects"] = win.units
        picks = cell.sample()
        made = [(cell.done[i][1], cell.done[i][2]) for i in picks]
        altered = []
        if control:
            # The colour channels reversed where the Gaussians are made,
            # then the program's own orbit of them.
            for g, _ in made:
                g = np.array(g)
                g[..., 11:14] = g[..., 13:10:-1]
                altered.append((g, cell.infer.render_orbit_video(
                    g, cell.opt, n_frames=ctx.traffic["frames"],
                    chunk=ctx.traffic["chunk"], device=device,
                    n_devices=ctx.chips)))
        cell.release()
        ref = cell.gaussians(picks)
        judged = cell.frames([g for g, _ in made])
        out["program"] = mod.compare(made, ref, judged)
        # For information: the frames against the plain renderer's frames
        # of the plain LGM's Gaussians (end to end).
        out["frames_end_to_end"] = mod.compare(made, ref, cell.frames(ref))
        if control:
            out["control"] = mod.compare(*cell.control(picks))
            out["altered_gaussians"] = mod.compare(
                altered, ref, cell.frames([g for g, _ in altered]))
            # One frame of each object with its colour channels reversed.
            frames = [(g, f.copy()) for g, f in made]
            for _, f in frames:
                f[0] = f[0][..., ::-1]
            out["altered_frame"] = mod.compare(frames, ref, judged)
    out["wall_s"] = time.time() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw", default=None,
                    help="directory for each seed's raw readings (JSON)")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--verdict", choices=("control", "half"),
                    default=None)
    ap.add_argument("--options", type=json.loads, default=None,
                    help="JSON overrides of the configuration's options "
                    "(a second witness: the program in f32)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        if args.verdict:
            print(json.dumps(verdict(args.workload, seed, args.verdict,
                                     args.seconds)), flush=True)
            torch.cuda.empty_cache()
            continue
        out = one_seed(args.workload, seed, i < args.control, args.seconds,
                       options=args.options)
        raw = out.pop("raw", None)
        if args.raw and raw is not None:
            for side in raw.values():
                side["gaussians"] = None
            os.makedirs(args.raw, exist_ok=True)
            with open(os.path.join(args.raw, f"{seed}.json"), "w") as f:
                json.dump(raw, f)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
