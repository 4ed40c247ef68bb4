"""Training entry point: LGM on one GPU with synthetic data.

Port of ``lgm_tpu/train.py`` (ref: main.py:13-185) for a single device:
AdamW with the reference hyperparameters (lr 4e-4, weight decay 0.05,
betas 0.9/0.95, main.py:73-74) under optax's cosine one-cycle schedule
with warmup (main.py:75-79), global-norm clipping at 1.0 (main.py:105-106),
gradient accumulation as ``optax.MultiSteps`` and bf16 compute. The
optimizer is written out rather than taken from ``torch.optim`` because
lgm_tpu's differs from it: the first moment is kept in bf16
(``mu_dtype=jnp.bfloat16``), with optax's order of casts, and the clip is
optax's ``t / norm * max_norm``, not ``clip_grad_norm_``'s ``+ 1e-6``.
LPIPS is frozen: no gradient and no optimizer state.

Checkpoints carry the full state (parameters, optimizer state, step) as
``<workspace>/ckpt_{step}`` (``torch.save``); SIGTERM/SIGINT save after the
in-flight step and ``--resume auto`` continues from the newest one.
``--profile-steps N`` writes a ``torch.profiler`` trace of steps
[10, 10 + N) to ``<workspace>/trace``.

Run:  python -m lgm_tpu_torch.train big --workspace ws --total-steps N
      [--device cuda|cpu] [--rasterizer auto|pallas|pallas_v1|xla]
      [any Options field as --flag]

``--rasterizer`` picks the renderer of the train step and the eval
renders (``models/lgm.py::rasterizer_backend``): flatsort (kernels K2,
K2ᵇ) for ``auto``/``pallas``, the v1 tiled rasterizer (K3, K3ᵇ) for
``pallas_v1``, the exact oracle for ``xla``.

Scalars go to ``<workspace>/metrics.jsonl``, and to TensorBoard under
``<workspace>/tb`` where ``torch.utils.tensorboard`` imports.

Not yet ported: ``data_mode`` other than ``synthetic``, ``vp > 1`` and
``zero1`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from lgm_tpu_torch.config import Options, parse_cli
from lgm_tpu_torch.infer import resolve_device
from lgm_tpu_torch.models.lgm import LGMWithLoss
from lgm_tpu_torch.models.lpips import load_lpips_params
from lgm_tpu_torch.models.unet import use_full_float32

B1, B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.05
B1_BF16 = float(torch.tensor(B1, dtype=torch.bfloat16))  # 0.8984375


def current_lr(opt: Options, step: int) -> float:
    """The learning rate at optax count ``step``:
    ``optax.cosine_onecycle_schedule(transition_steps, peak_value=lr,
    pct_start=warmup/transition_steps, div_factor=25,
    final_div_factor=1e4)`` with transition_steps = max(total_steps,
    warmup_steps + 1), in optax's f32 arithmetic. (An empty warmup
    interval is skipped; optax's 0/0 there would give NaN.)"""
    total = max(opt.total_steps, opt.warmup_steps + 1)
    bounds = [0, int(opt.warmup_steps / total * total), int(total)]
    values = np.cumprod([opt.lr / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    f32 = np.float32
    if step >= bounds[-1]:
        return float(f32(values[-1]))
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        if lo <= step < hi:
            pct = f32(step - lo) / f32(hi - lo)
            half = f32((values[i] - values[i + 1]) / 2.0)
            cos = f32(np.cos(f32(np.pi) * pct))
            return float(f32(values[i + 1]) + half * (cos + f32(1)))
    raise ValueError(f"step {step} < 0")


class Optimizer:
    """optax.chain(clip_by_global_norm(clip), adamw(schedule, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay=0.05, mu_dtype=bf16)), wrapped in
    MultiSteps when ``gradient_accumulation_steps > 1``; over ``params``,
    updated in place by ``update(grads)``."""

    def __init__(self, params: List[torch.nn.Parameter], opt: Options):
        self.params = list(params)
        self.opt = opt
        self.count = 0          # Adam's and the schedule's count
        self.mu = [torch.zeros_like(p, dtype=torch.bfloat16)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.k_steps = opt.gradient_accumulation_steps
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k_steps > 1 else None)

    def update(self, grads: List[torch.Tensor],
               g_norm: Optional[torch.Tensor] = None) -> None:
        """One optimizer call; ``g_norm`` is ``global_norm(grads)`` when
        the caller has it already."""
        if self.acc is not None:
            # MultiSteps: running mean of the micro-step gradients; the
            # inner update runs on every k-th call, clipped by the norm of
            # that mean.
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < self.k_steps - 1:
                self.mini_step += 1
                return
            grads, self.mini_step, g_norm = self.acc, 0, None
        self._apply(grads, global_norm(grads) if g_norm is None else g_norm)
        if self.acc is not None:
            for a in self.acc:
                a.zero_()

    @torch.no_grad()
    def _apply(self, grads: List[torch.Tensor],
               g_norm: torch.Tensor) -> None:
        max_norm = self.opt.gradient_clip
        keep = g_norm < max_norm
        lr = current_lr(self.opt, self.count)
        self.count += 1
        dev = g_norm.device
        # Bias corrections 1 - b**count in f32, as optax computes them.
        bc1 = 1 - torch.tensor(B1, device=dev) ** self.count
        bc2 = 1 - torch.tensor(B2, device=dev) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, (g / g_norm) * max_norm)
            # optax's b1 * mu under jit (ROADMAP trap C4): the weak-typed
            # b1 takes mu's dtype (bf16(0.9) = 0.8984375), XLA forms the
            # product and the sum in f32, and mu is rounded to bf16 once,
            # when stored. (1 - b1) stays the f32 0.1.
            mu_f = (1 - B1) * g + B1_BF16 * mu.float()
            nu.mul_(B2).add_((1 - B2) * (g * g))
            u = (mu_f / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            u = u + WEIGHT_DECAY * p
            p.add_(u * (-lr))
            mu.copy_(mu_f)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: Dict) -> None:
        for name in ("mu", "nu") + (("acc",) if self.acc is not None else ()):
            for dst, src in zip(getattr(self, name), sd[name]):
                if dst.shape != src.shape:
                    raise ValueError(f"optimizer {name}: shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of all squares (f32)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def make_optimizer(opt: Options, model: LGMWithLoss) -> Optimizer:
    """The optimizer over every trained leaf: the LGM's parameters (LPIPS
    is frozen and gets no state, ref: core/models.py:46-49)."""
    return Optimizer(model.lgm.parameters(), opt)


@dataclass
class TrainState:
    model: LGMWithLoss
    optimizer: Optimizer
    step: int = 0


def create_state(opt: Options, device="cuda", backend: Optional[str] = None,
                 seed: int = 42) -> TrainState:
    """The model in the preset's compute dtype with weights initialised
    under ``seed`` (LPIPS from ``opt.lpips_weights`` when given), on
    ``device``, and its optimizer."""
    for what, bad in (("data_mode", opt.data_mode != "synthetic"),
                      ("vp", opt.vp > 1), ("zero1", opt.zero1)):
        if bad:
            raise NotImplementedError(
                f"{what}={getattr(opt, what)!r} is not ported yet (disk "
                "datasets and multi-GPU training come in later slices)")
    dev = resolve_device(device) if isinstance(device, str) else device
    use_full_float32()
    dtype = torch.bfloat16 if opt.mixed_precision == "bf16" else torch.float32
    rng_devices = ([torch.cuda.current_device() if dev.index is None
                    else dev.index] if dev.type == "cuda" else [])
    with torch.random.fork_rng(devices=rng_devices):
        torch.manual_seed(seed)
        with dev:
            model = LGMWithLoss(opt, dtype=dtype,
                                backend=backend or opt.rasterizer)
    if opt.lpips_weights and model.lpips_loss is not None:
        load_lpips_params(model.lpips_loss, opt.lpips_weights)
    return TrainState(model, make_optimizer(opt, model))


def train_step(state: TrainState, data: Dict, bg: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """One optimization step with background colour ``bg`` [3] (drawn
    per step by the caller, ref: core/models.py:135-138). Returns the
    step's metrics as 0-d tensors: loss, loss_mse, psnr, gnorm (of the raw
    gradient) and loss_lpips / loss_reg when the loss has them."""
    params = state.optimizer.params
    for p in params:
        p.grad = None
    # Named ranges, as lgm_tpu's named_scope: a torch.profiler trace
    # attributes device time to each.
    with record_function("loss_forward"):
        out = state.model(data, bg)
    with record_function("loss_backward"):
        out["loss"].backward()
    with record_function("optimizer"):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        gnorm = global_norm(grads)
        state.optimizer.update(grads, gnorm)
    for p in params:
        p.grad = None
    state.step += 1
    metrics = {"loss": out["loss"], "loss_mse": out["loss_mse"],
               "psnr": out["psnr"], "gnorm": gnorm}
    for key in ("loss_lpips", "loss_reg"):
        if key in out:
            metrics[key] = out[key]
    return {k: v.detach() for k, v in metrics.items()}


def eval_step(state: TrainState, data: Dict) -> Dict[str, torch.Tensor]:
    """White background at eval (ref: core/models.py:137-138)."""
    dev = data["input"].device
    with torch.no_grad():
        out = state.model(data, torch.ones(3, device=dev))
    return {"loss": out["loss"], "psnr": out["psnr"],
            "images_pred": out["images_pred"]}


def save_checkpoint(workspace: str, state: TrainState, step: int) -> str:
    path = os.path.abspath(os.path.join(workspace, f"ckpt_{step}"))
    tmp = path + ".tmp"
    torch.save({"params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict(), "step": step},
               tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(workspace: str) -> Optional[str]:
    """Highest-step ckpt_N in the workspace (for --resume auto)."""
    best, best_step = None, -1
    for name in os.listdir(workspace) if os.path.isdir(workspace) else []:
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(workspace, name), int(m.group(1))
    return best


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Full-state resume. Where shapes do not match (another preset), only
    the shape-matched parameters load and the rest keep their init, as
    the reference's loader does (ref: main.py:28-44)."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    own = state.model.state_dict()
    params = ckpt["params"]
    if set(params) == set(own) and all(
            params[k].shape == own[k].shape for k in own):
        state.model.load_state_dict(params)
        state.optimizer.load_state_dict(ckpt["opt_state"])
        state.step = int(ckpt["step"])
        return state
    with torch.no_grad():
        for k, v in params.items():
            if k in own and own[k].shape == v.shape:
                own[k].copy_(v)
    print("[warn] partial checkpoint restore (shape-matched params only)")
    return state


def make_datasets(opt: Options, device):
    from lgm_tpu_torch.data.synthetic import SyntheticDataset

    return (SyntheticDataset(opt, training=True, device=device),
            SyntheticDataset(opt, training=False, length=4, device=device))


def _batch_data(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if k != "scenes"}


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda",
                     help="cuda (default) or cpu")
    ns, rest = pre.parse_known_args(argv)
    opt = parse_cli(rest)
    dev = resolve_device(ns.device)
    if opt.debug_nans:
        # The nearest counterpart of jax_debug_nans: autograd raises at
        # the backward op that produced a NaN.
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(opt.workspace, exist_ok=True)
    print(f"device: {dev}")

    from lgm_tpu_torch.utils.logging import MetricLogger, save_image_grid

    logger = MetricLogger(opt.workspace)
    state = create_state(opt, dev)
    train_ds, test_ds = make_datasets(opt, dev)
    if opt.resume:
        resume = opt.resume
        if resume == "auto":
            resume = latest_checkpoint(opt.workspace)
            if resume:
                print(f"auto-resuming from {resume}")
        if resume:
            state = load_checkpoint(resume, state)

    def run_eval():
        evals = [{k: float(v) for k, v in eval_step(
            state, _batch_data(test_ds.batch(i))).items()
            if k != "images_pred"} for i in range(len(test_ds))]
        return {k: float(np.mean([e[k] for e in evals])) for k in evals[0]}

    if opt.eval_only:
        emeans = run_eval()
        logger.log(state.step, emeans, prefix="eval")
        print("eval-only: "
              + " ".join(f"{k} {v:.4f}" for k, v in emeans.items()))
        logger.close()
        return emeans

    # Background colours from an explicit generator, one draw per step.
    gen = torch.Generator().manual_seed(42)
    step, max_steps = state.step, opt.total_steps
    t_last = time.time()
    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    try:
        prev_handlers = {s: signal.signal(s, _on_term)
                         for s in (signal.SIGTERM, signal.SIGINT)}
    except ValueError:  # not the main thread (driven from a test)
        prev_handlers = {}
    prof = None
    prof_start = 10 if opt.profile_steps > 0 else -1
    prof_stop = prof_start + opt.profile_steps
    try:
        while step < max_steps:
            if step == prof_start:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
            if step == prof_stop and prof is not None:
                prof.stop()
                os.makedirs(os.path.join(opt.workspace, "trace"),
                            exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    opt.workspace, "trace", "trace.json"))
                prof = None
                print(f"wrote trace to {opt.workspace}/trace")
            batch = train_ds.batch(step)
            data = _batch_data(batch)
            bg = torch.rand(3, generator=gen).to(dev)
            metrics = train_step(state, data, bg)
            step = state.step
            if stop_requested["flag"]:
                path = save_checkpoint(opt.workspace, state, step)
                print(f"preemption save at step {step}: {path}")
                break
            if step % 100 == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                t_last = time.time()
                m["lr"] = current_lr(opt, step)
                logger.log(step, m, prefix="train")
                print(f"step {step}: loss {m['loss']:.4f} "
                      f"psnr {m['psnr']:.2f} ({dt:.1f}s/100it)", flush=True)
            if step % 500 == 0:
                ev = eval_step(state, data)
                save_image_grid(
                    os.path.join(opt.workspace, f"train_images_{step}.jpg"),
                    batch["images_output"].cpu().numpy(),
                    ev["images_pred"].cpu().numpy())
            if step % opt.eval_every == 0 or step == max_steps:
                emeans = run_eval()
                logger.log(step, emeans, prefix="eval")
                print(f"eval @ {step}: " + " ".join(
                    f"{k} {v:.4f}" for k, v in emeans.items()), flush=True)
                path = save_checkpoint(opt.workspace, state, step)
                print(f"saved {path}", flush=True)
    finally:
        if prof is not None:
            prof.stop()
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        logger.close()


if __name__ == "__main__":
    main()
