"""Training entry point: LGM on one GPU or several, on synthetic or disk
data.

Port of ``lgm_tpu/train.py`` (ref: main.py:13-185): AdamW with the
reference hyperparameters (lr 4e-4, weight decay 0.05, betas 0.9/0.95,
main.py:73-74) under optax's cosine one-cycle schedule
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

``--data-mode objaverse|lvis`` (with ``--data-path`` /
``--data-path-rendering``) trains on renderings read from disk
(``data/provider.py``: ``--num-workers`` loader processes, batches copied
to the device without blocking); ``synthetic`` renders its scenes.

Several processes (``python -m torch.distributed.run --nproc_per_node N
-m lgm_tpu_torch.train ...``; NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) form a (dp, vp) world (``parallel/dist.py``): each rank
takes its part of the global batch of ``batch_size`` scenes, the LGM runs
under DistributedDataParallel (LPIPS, frozen, outside it), ``--zero1 1``
shards the optimizer state over dp, every rank draws the same background
colours, and logged scalars and eval means are reduced over the world, so
they are a one-process run's. Rank 0 logs, writes image grids and writes
the checkpoint (full state: ZeRO-1 shards are gathered first, so one
process loads it). A preemption signal on any rank stops all of them
after the same step.
"""

from __future__ import annotations

import argparse
import functools
import os
import re
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from lgm_tpu_torch.config import Options, parse_cli
from lgm_tpu_torch.infer import resolve_device
from lgm_tpu_torch.models.lgm import LGMWithLoss
from lgm_tpu_torch.models.lpips import load_lpips_params
from lgm_tpu_torch.models.unet import use_full_float32
from lgm_tpu_torch.parallel import dist

B1, B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.05
B1_BF16 = float(torch.tensor(B1, dtype=torch.bfloat16))  # 0.8984375


@dataclass(frozen=True)
class AdamW:
    """An optax chain ``clip_by_global_norm(clip)``, then ``adamw(schedule,
    b1=0.9, b2, eps, weight_decay, mu_dtype=bf16)`` over every leaf (no
    mask), in ``MultiSteps(every_k)`` when ``every_k`` > 1. ``schedule``
    maps Adam's count before it increments to the learning rate, in
    optax's f32 arithmetic."""

    schedule: Callable[[int], float]
    clip: float
    b2: float
    weight_decay: float
    eps: float = ADAM_EPS
    every_k: int = 1


def lgm_chain(opt: Options) -> AdamW:
    """LGM's chain (``lgm_tpu/train.py``): b2 0.95, weight decay 0.05, the
    one-cycle schedule of ``current_lr``."""
    return AdamW(functools.partial(current_lr, opt), opt.gradient_clip, B2,
                 WEIGHT_DECAY, every_k=opt.gradient_accumulation_steps)


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
    """The ``AdamW`` chain over ``params`` (``opt`` an ``AdamW``, or the
    ``Options`` whose ``lgm_chain`` it is), updated in place by
    ``update(grads)``. After ``shard(world)``, ZeRO-1."""

    def __init__(self, params: List[torch.nn.Parameter],
                 opt: Union[Options, AdamW]):
        self.params = list(params)
        self.chain = opt if isinstance(opt, AdamW) else lgm_chain(opt)
        self.count = 0          # Adam's and the schedule's count
        self.mu = [torch.zeros_like(p, dtype=torch.bfloat16)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.k_steps = self.chain.every_k
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.k_steps > 1 else None)
        self.world: Optional[dist.World] = None
        self.axes: List[Optional[int]] = [None] * len(self.params)

    def shard(self, world: dist.World) -> None:
        """ZeRO-1 over dp (lgm_tpu's ``shard_opt_state``): each leaf of at
        least 2^16 elements keeps Adam's moments for its dp rank's slice
        along ``dist.zero1_axis``; the update runs on that slice of the
        gradient (all-reduced in full, so the clip reads the global norm)
        and an all-gather over dp restores the parameter. Smaller leaves
        stay replicated; the accumulator of MultiSteps stays whole."""
        self.world = world
        for i, p in enumerate(self.params):
            axis = dist.zero1_axis(tuple(p.shape), world.dp)
            self.axes[i] = axis
            if axis is not None:
                self.mu[i] = dist.local_slice(self.mu[i], axis, world).clone()
                self.nu[i] = dist.local_slice(self.nu[i], axis, world).clone()

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
        chain = self.chain
        b2, max_norm = chain.b2, chain.clip
        keep = g_norm < max_norm
        lr = chain.schedule(self.count)
        self.count += 1
        dev = g_norm.device
        # Bias corrections 1 - b**count in f32, as optax computes them.
        bc1 = 1 - torch.tensor(B1, device=dev) ** self.count
        bc2 = 1 - torch.tensor(b2, device=dev) ** self.count
        for p, g, mu, nu, axis in zip(self.params, grads, self.mu, self.nu,
                                      self.axes):
            g = torch.where(keep, g, (g / g_norm) * max_norm)
            full = p
            if axis is not None:   # ZeRO-1: this rank's slice
                p = dist.local_slice(p, axis, self.world)
                g = dist.local_slice(g, axis, self.world)
            # optax's b1 * mu under jit (ROADMAP trap C4): the weak-typed
            # b1 takes mu's dtype (bf16(0.9) = 0.8984375), XLA forms the
            # product and the sum in f32, and mu is rounded to bf16 once,
            # when stored. (1 - b1) stays the f32 0.1.
            mu_f = (1 - B1) * g + B1_BF16 * mu.float()
            nu.mul_(b2).add_((1 - b2) * (g * g))
            u = (mu_f / bc1) / (torch.sqrt(nu / bc2) + chain.eps)
            u = u + chain.weight_decay * p
            p.add_(u * (-lr))
            mu.copy_(mu_f)
            if axis is not None:
                full.copy_(dist.gather_slices(p, axis, self.world))

    def _full(self, name: str) -> List[torch.Tensor]:
        """Adam's ``mu`` or ``nu``, ZeRO-1 slices gathered (collective)."""
        return [t if axis is None else dist.gather_slices(t, axis, self.world)
                for t, axis in zip(getattr(self, name), self.axes)]

    def state_dict(self) -> Dict:
        """The full state, as one process holds it: under ZeRO-1 every
        rank must call it (the slices are gathered)."""
        return {"count": self.count, "mu": self._full("mu"),
                "nu": self._full("nu"), "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, sd: Dict) -> None:
        """Load a full state (under ZeRO-1, each rank keeps its slices)."""
        for name in ("mu", "nu") + (("acc",) if self.acc is not None else ()):
            axes = self.axes if name != "acc" else [None] * len(self.params)
            for dst, src, p, axis in zip(getattr(self, name), sd[name],
                                         self.params, axes):
                if p.shape != src.shape:
                    raise ValueError(f"optimizer {name}: shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(p.shape)}")
                dst.copy_(src if axis is None else
                          dist.local_slice(src, axis, self.world))
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
    """The model in the preset's compute dtype, on ``device``, with
    flax's initialisers drawn from a CPU generator seeded with ``seed``
    (the same weights on every device; LPIPS from ``opt.lpips_weights``
    when given), and its optimizer (``main`` shards it under ``zero1``)."""
    dev = resolve_device(device) if isinstance(device, str) else device
    use_full_float32()
    dtype = torch.bfloat16 if opt.mixed_precision == "bf16" else torch.float32
    rng_devices = ([torch.cuda.current_device() if dev.index is None
                    else dev.index] if dev.type == "cuda" else [])
    # PyTorch's default init, drawn from the global RNG as the modules are
    # built and then replaced, must not move the caller's RNG.
    with torch.random.fork_rng(devices=rng_devices), dev:
        model = LGMWithLoss(opt, dtype=dtype,
                            backend=backend or opt.rasterizer,
                            generator=torch.Generator().manual_seed(seed))
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


def model_state_dict(model: LGMWithLoss) -> Dict[str, torch.Tensor]:
    """The model's state dict under a one-process run's keys (the
    ``module.`` of a DistributedDataParallel around ``lgm`` dropped)."""
    return {("lgm." + k[len("lgm.module."):]
             if k.startswith("lgm.module.") else k): v
            for k, v in model.state_dict().items()}


def save_checkpoint(workspace: str, state: TrainState, step: int,
                    world: Optional[dist.World] = None) -> str:
    """``<workspace>/ckpt_{step}``: parameters, the full optimizer state
    and the step. In a world of several ranks every rank calls it (ZeRO-1
    slices are gathered) and rank 0 writes."""
    path = os.path.abspath(os.path.join(workspace, f"ckpt_{step}"))
    ckpt = {"params": model_state_dict(state.model),
            "opt_state": state.optimizer.state_dict(), "step": step}
    if world is None or world.is_lead:
        tmp = path + ".tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    if world is not None:
        dist.barrier(world)
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


class _RankBatches:
    """A dataset's ``batch(step)`` as the rank's part (``dist.shard_batch``)
    of the global batch every rank makes alike (synthetic data)."""

    def __init__(self, ds, world: dist.World):
        self.ds, self.world = ds, world

    def __len__(self):
        return len(self.ds)

    def batch(self, step: int) -> Dict:
        return dist.shard_batch(self.world, _batch_data(self.ds.batch(step)))


class DiskBatches:
    """A disk dataset behind the synthetic ``batch(step)`` API
    (``lgm_tpu/train.py``'s ``_Adapter``): successive batches of the
    ``Loader``, epoch after epoch (for training one stream, so the workers
    prefetch across an epoch's end), each the rank's dp slice of the
    global batch, copied to ``device`` without blocking (from pinned
    memory on CUDA); the vp ranks of a scene take the first one's copy
    (``dist.broadcast_scenes``) and keep their views."""

    def __init__(self, ds, opt: Options, device: torch.device,
                 world: dist.World, training: bool):
        from lgm_tpu_torch.data.provider import Loader

        self.loader = Loader(ds, opt.batch_size, shuffle=training,
                             workers=opt.num_workers, rank=world.dp_rank,
                             ranks=world.dp,
                             pin_memory=device.type == "cuda",
                             endless=training)
        self.device, self.world = device, world
        self._iter = None
        self._epoch = 0

    def __len__(self):
        return max(len(self.loader), 1)

    def batch(self, step: int) -> Dict:
        if self._iter is None:
            self._iter = self.loader.epoch(self._epoch)
        try:
            batch = next(self._iter)
        except StopIteration:
            self._epoch += 1
            self._iter = self.loader.epoch(self._epoch)
            batch = next(self._iter)
        batch = {k: v.to(self.device, non_blocking=True)
                 for k, v in batch.items()}
        return dist.shard_views(self.world,
                                dist.broadcast_scenes(self.world, batch))

    def close(self) -> None:
        self.loader.close()


def make_datasets(opt: Options, device, world: Optional[dist.World] = None):
    """Train and test batches by ``data_mode``: ``synthetic`` (rendered on
    ``device``), ``objaverse`` or ``lvis`` (from disk); in a world of
    several ranks, each rank's part."""
    device = torch.device(device)
    world = world or dist.World(device=device)
    if opt.data_mode == "synthetic":
        from lgm_tpu_torch.data.synthetic import SyntheticDataset

        sets = (SyntheticDataset(opt, training=True, device=device),
                SyntheticDataset(opt, training=False, length=4,
                                 device=device))
        if world.size == 1:
            return sets
        return tuple(_RankBatches(ds, world) for ds in sets)
    from lgm_tpu_torch.data.provider import LVISDataset, ObjaverseDataset

    cls = {"objaverse": ObjaverseDataset, "lvis": LVISDataset}[opt.data_mode]
    return (DiskBatches(cls(opt, training=True), opt, device, world, True),
            DiskBatches(cls(opt, training=False), opt, device, world, False))


def _batch_data(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if k != "scenes"}


def main(argv=None):
    """The trainer's CLI (see the module docstring). Returns the eval
    means under ``--eval-only``."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda",
                     help="cuda (default) or cpu")
    ns, rest = pre.parse_known_args(argv)
    opt = parse_cli(rest)
    world = dist.init_world(opt.vp, resolve_device(ns.device))
    dev = world.device
    logger, sets = None, ()
    try:
        if opt.debug_nans:
            # The nearest counterpart of jax_debug_nans: autograd raises at
            # the backward op that produced a NaN.
            torch.autograd.set_detect_anomaly(True)
        os.makedirs(opt.workspace, exist_ok=True)
        if world.is_lead:
            from lgm_tpu_torch.utils.logging import MetricLogger

            print(f"device: {dev}, world: {world.size} (dp {world.dp} x vp "
                  f"{world.vp})")
            logger = MetricLogger(opt.workspace)
        state = create_state(opt, dev)
        sets = make_datasets(opt, dev, world)
        return _run(opt, dev, world, state, *sets, logger)
    finally:
        for ds in sets:
            if isinstance(ds, DiskBatches):
                ds.close()
        if logger is not None:
            logger.close()
        dist.close(world)


def _run(opt: Options, dev: torch.device, world: dist.World,
         state: TrainState, train_ds, test_ds, logger):
    from lgm_tpu_torch.utils.logging import save_image_grid

    lead = world.is_lead
    if opt.resume:
        resume = opt.resume
        if resume == "auto":
            resume = latest_checkpoint(opt.workspace)
            if resume and lead:
                print(f"auto-resuming from {resume}")
        if resume:
            state = load_checkpoint(resume, state)
    if opt.zero1:
        state.optimizer.shard(world)
    if world.distributed:
        # Gradients are averaged over the world in the backward; the
        # wrapper's first act is to broadcast rank 0's parameters (the LGM
        # has no buffers).
        from torch.nn.parallel import DistributedDataParallel

        state.model.lgm = DistributedDataParallel(
            state.model.lgm,
            device_ids=[dev.index] if dev.type == "cuda" else None)

    def run_eval():
        evals = [dist.reduce_metrics(world, {
            k: v for k, v in eval_step(
                state, _batch_data(test_ds.batch(i))).items()
            if k != "images_pred"}) for i in range(len(test_ds))]
        return {k: float(np.mean([e[k] for e in evals])) for k in evals[0]}

    if opt.eval_only:
        emeans = run_eval()
        if lead:
            logger.log(state.step, emeans, prefix="eval")
            print("eval-only: "
                  + " ".join(f"{k} {v:.4f}" for k, v in emeans.items()))
        return emeans

    # Background colours from an explicit generator, one draw per step,
    # the same on every rank.
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
    prof_start = 10 if opt.profile_steps > 0 and lead else -1
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
            data = _batch_data(train_ds.batch(step))
            bg = torch.rand(3, generator=gen).to(dev)
            metrics = train_step(state, data, bg)
            step = state.step
            if dist.any_rank(world, stop_requested["flag"]):
                path = save_checkpoint(opt.workspace, state, step, world)
                if lead:
                    print(f"preemption save at step {step}: {path}")
                break
            if step % 100 == 0 or step == 1:
                m = dist.reduce_metrics(world, metrics)
                dt = time.time() - t_last
                t_last = time.time()
                m["lr"] = current_lr(opt, step)
                if lead:
                    logger.log(step, m, prefix="train")
                    print(f"step {step}: loss {m['loss']:.4f} "
                          f"psnr {m['psnr']:.2f} ({dt:.1f}s/100it)",
                          flush=True)
            if step % 500 == 0 and lead:
                # The lead rank's part of the batch.
                ev = eval_step(state, data)
                save_image_grid(
                    os.path.join(opt.workspace, f"train_images_{step}.jpg"),
                    data["images_output"].cpu().numpy(),
                    ev["images_pred"].cpu().numpy())
            if step % opt.eval_every == 0 or step == max_steps:
                emeans = run_eval()
                path = save_checkpoint(opt.workspace, state, step, world)
                if lead:
                    logger.log(step, emeans, prefix="eval")
                    print(f"eval @ {step}: " + " ".join(
                        f"{k} {v:.4f}" for k, v in emeans.items()),
                        flush=True)
                    print(f"saved {path}", flush=True)
    finally:
        if prof is not None:
            prof.stop()
        for s, h in prev_handlers.items():
            signal.signal(s, h)


if __name__ == "__main__":
    main()
