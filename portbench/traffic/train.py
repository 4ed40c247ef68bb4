"""Traffic ``train``: the program's training step back to back, one client.

Set-up builds one ``train.create_state`` in the configuration's settings,
loads the benchmark's seeded weights into it, renders a cycle of
``batches`` distinct batches with the plain renderer, draws a background
colour a step, and drives the state through its first ``check_steps``
steps with ``train.train_step`` (they warm up every shape the window
uses). The window continues the same state, step after step, on the
cycle of batches; it ends at the synchronize of its last whole step.

The check: the plain reference (``reference/train.py``) follows the same
first steps from the same weights, batches and backgrounds, in f32, and
``compare`` holds the program's first steps to it: the Gaussians the
first step's U-Net made for each scene (read by a forward hook on the
program's LGM during that step only), each weight's first gradient as the
optimizer took it (from Adam's second moment after one step, nu = (1 - b2)
g²) and each weight's change over the steps.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import Window
from portbench.reference import lgm as ref_lgm
from portbench.reference import lpips as ref_lpips
from portbench.reference import scenes, weights
from portbench.reference.precision import PRECISIONS, f32_only
from portbench.reference.train import B2, follow
from portbench.counts import attention, flops
from portbench.timeline import WINDOW


def make_options(options: dict):
    from lgm_tpu_torch.config import Options

    return Options(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in options.items()})


def model_weights(ctx, device):
    """The LGM's and LPIPS's weights under ``LGMWithLoss``'s names, one
    draw from the seed."""
    shapes = {f"lgm.{k}": s for k, s in
              ref_lgm.param_shapes(ctx.options).items()}
    if ctx.options["lambda_lpips"] > 0:
        shapes.update({f"lpips_loss.{k}": s for k, s in
                       ref_lpips.param_shapes().items()})
    init = {f"lgm.{k}": v for k, v in
            ctx.config["assumed"].get("init", {}).items()}
    return weights.make(shapes, ctx.seed, device, init)


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    med = statistics.median(ref[k] for k in names)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in names]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the check compares (``readings`` of each side):

    - ``gauss_gap``: the worst scene's ||g - g_ref|| / ||g_ref|| of the
      first step's Gaussians; a scene the program made none for reads 1;
    - ``grad_med``: the median leaf's gap of the first gradient's norm as
      the optimizer took it, from its state after the step;
    - ``step_gap``: the worst leaf's gap of the change over the steps.

    The losses, the first gradient's global norm, its worst leaf and the
    leaves' directions are not compared: they read the renderer's
    discontinuity (a splat rounded by a pixel reorders the front ones) as
    much as the precision, and the control reads as low as the program on
    some seeds (PERF.md). Leaves whose reference gradient is
    under a thousandth of the median leaf's have only round-off to show
    and are left out of the leaf numbers."""
    med = statistics.median(ref["grad"].values())
    moved = [k for k in ref["grad"] if ref["grad"][k] >= 1e-3 * med]

    made, want = prog["gaussians"].double(), ref["gaussians"].double()
    gauss = max(float(torch.linalg.vector_norm(made[b] - want[b])
                      / torch.linalg.vector_norm(want[b]))
                if b < len(made) else 1.0 for b in range(len(want)))
    return {"gauss_gap": gauss,
            "grad_med": statistics.median(
                leaf_gaps(prog["grad"], ref["grad"], moved)),
            "step_gap": max(leaf_gaps(prog["change"], ref["change"],
                                      moved))}


class Clock:
    """Seconds of each stage of set-up, logged to standard error."""

    def __init__(self, sync):
        self.sync, self.t = sync, time.perf_counter()

    def __call__(self, stage: str):
        self.sync()
        now = time.perf_counter()
        print(f"portbench: set-up {stage} {now - self.t:.2f} s",
              file=sys.stderr)
        self.t = now


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = torch.device(ctx.device)
        self.cuda = self.dev.type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def setup(self):
        from lgm_tpu_torch import train as prog

        ctx, p = self.ctx, self.ctx.traffic
        clock = Clock(self._sync)
        self.prog = prog
        self.opt = make_options(ctx.options)
        self.w = model_weights(ctx, self.dev)
        clock("weights")
        self.state = prog.create_state(self.opt, self.dev)
        self.state.model.load_state_dict(self.w)
        clock("create_state")
        rng = np.random.default_rng(ctx.seed)
        self.batches = [scenes.train_batch(rng, ctx.options,
                                           self.opt.batch_size,
                                           p["scene_gaussians"], self.dev)
                        for _ in range(p["batches"])]
        gen = weights.generator(ctx.seed + 1, self.dev)
        self.bgs = torch.rand(p["backgrounds"], 3, generator=gen,
                              device=self.dev)
        clock("batches")
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.readings = self._first_steps(p["check_steps"])
        clock("first_steps")

    def _data(self, step: int):
        return (self.batches[step % len(self.batches)],
                self.bgs[step % len(self.bgs)])

    def _first_steps(self, n: int) -> dict:
        """Steps 1..n of the state; the numbers the check compares."""
        st = self.state
        names = [f"lgm.{k}" for k, _ in st.model.lgm.named_parameters()]
        p0 = [self.w[k] for k in names]
        losses, grad, made = [], None, []
        self.step = 0
        for i in range(n):
            hook = None
            if i == 0:
                hook = st.model.lgm.register_forward_hook(
                    lambda mod, args, out: made.append(
                        out.detach().float().cpu()))
            try:
                m = self.prog.train_step(st, *self._data(i))
            finally:
                if hook is not None:
                    hook.remove()
            losses.append(m["loss"])
            self.step += 1
            if i == 0:
                grad = [torch.sqrt(nu.sum() / (1 - B2))
                        for nu in st.optimizer.nu]
        change = [torch.linalg.vector_norm(p.detach() - q)
                  for p, q in zip(st.optimizer.params, p0)]
        return {"losses": [float(x) for x in losses],
                "grad": {k: float(v) for k, v in zip(names, grad)},
                "gaussians": made[0],
                "change": {k: float(v) for k, v in zip(names, change)}}

    def window(self, seconds: float) -> Window:
        losses, ends = [], []
        self._sync()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            while True:
                with record_function("portbench.step"):
                    m = self.prog.train_step(self.state,
                                             *self._data(self.step))
                losses.append(m["loss"])
                self.step += 1
                ends.append(time.perf_counter())
                if ends[-1] - t0 >= seconds:
                    break
            self._sync()
            t1 = time.perf_counter()
        failed = sum(not math.isfinite(float(x)) for x in losses)
        # Host seconds between the steps' returns (no sync between them).
        steps = np.diff([t0] + ends).tolist()
        return Window(units=len(losses), attempted=len(losses), failed=failed,
                      seconds=t1 - t0, spans={"step": steps})

    def end_to_end(self, win: Window) -> dict:
        out = {"train_samples_per_s":
               win.units * self.opt.batch_size / win.seconds}
        if self.cuda:
            out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return out

    def reading(self, win: Window) -> dict:
        opts, B = self.ctx.options, self.opt.batch_size
        sites = attention.lgm_sites(opts, B)
        return {"units": win.units, "spans": {},
                "flops_per_unit": flops.lgm_train_step(opts, B),
                # Under remat the forward's calls run again in the backward.
                "k1_calls": sites * (2 if opts["unet_remat"] else 1),
                "k1b_calls": sites}

    def release(self):
        del self.state
        self.prog = None
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32") -> dict:
        """The reference's numbers over the first steps, at ``precision``
        (``control``: the step below each stated precision)."""
        f32_only()
        n = self.ctx.traffic["check_steps"]
        lgm = {k[4:]: v for k, v in self.w.items() if k.startswith("lgm.")}
        lp = {k[11:]: v for k, v in self.w.items()
              if k.startswith("lpips_loss.")}
        data = [self._data(i) for i in range(n)]
        out = follow(lgm, lp, [d for d, _ in data], [b for _, b in data],
                     self.ctx.options, PRECISIONS[precision])
        return {"losses": out["losses"], "gaussians": out["gaussians"],
                "grad": {f"lgm.{k}": v for k, v in out["grad"].items()},
                "change": {f"lgm.{k}": v for k, v in out["change"].items()}}

    def check(self) -> dict:
        return compare(self.readings, self.reference())

    def control_check(self) -> dict:
        """``check`` with the control, the reference a step below each
        stated precision, in the program's place."""
        return compare(self.reference("control"), self.reference())
