"""Multi-view diffusion U-Net finetune (epsilon-prediction DDPM loss).

Port of ``lgm_tpu/diffusion/train.py``, the finetune that pairs with LGM
training in the pod-scale recipe:

- the frozen VAE encoder and CLIP towers make the latents and the context
  of each batch without gradient (the VAE posterior is *sampled*);
- one timestep t a scene, shared by its F frames (and ImageDream's
  reference frame): all frames of a scene carry one noise level, as the
  sampler denoises them jointly;
- classifier-free-guidance dropout: with probability ``cond_drop`` a
  scene's text context becomes the empty prompt's embedding and, on the
  ImageDream path, its image features and reference latent become zeros
  (the sampler's negative branch);
- ImageDream (``ip_dim`` > 0): frame 0 doubles as the reference image;
  the U-Net puts its clean latent into an appended placeholder frame and
  the loss covers the F content frames only;
- AdamW (``train.Optimizer`` over the chain of ``make_optimizer``: a
  linear warmup from 0, then the constant lr; b2 0.999, weight decay 0.01,
  a bf16 first moment, global-norm clipping), the U-Net in its compute
  dtype (bf16 at the published configs) over f32 parameters;
- an EMA shadow of the U-Net weights with the ramped decay
  min(decay, (1 + s) / (10 + s)); checkpoints carry it and ``export``
  writes it.

Host draws: ``prepare_batch`` takes, from one ``np.random.default_rng(seed)``
and in ``lgm_tpu``'s order and shapes, the VAE ε (NHWC), the dropout
draw, the noise (NHWC) and t, and only then moves to the device's NCHW,
so that a batch equals ``lgm_tpu``'s. Over several processes
(``torch.distributed.run``; NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) every rank makes the same global draws and encodes
only its own dp slice of the global batch of ``--batch-size`` scenes; the
U-Net runs under DistributedDataParallel (the frozen encoders outside
it), logged scalars are reduced over the ranks and rank 0 writes the
checkpoints and the export.

Checkpoints are ``<workspace>/dckpt_N`` (``torch.save`` of ``{"unet",
"opt_state", "ema", "step"}``, the moments and the EMA keyed by the
U-Net's parameter names); ``scripts/dckpt_to_torch.py`` turns one written
by ``lgm_tpu.diffusion.train`` into this form.

Run:  python -m lgm_tpu_torch.diffusion.train --pipeline mvdream \\
          [--ckpt DIR | --tokenizer DIR] --workspace ws --total-steps N \\
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from lgm_tpu_torch.diffusion.pipeline import MVDreamPipeline
from lgm_tpu_torch.diffusion.vae import SCALING_FACTOR
from lgm_tpu_torch.infer import resolve_device
from lgm_tpu_torch.parallel import dist
from lgm_tpu_torch.train import AdamW, Optimizer, global_norm

_F32 = np.float32


def warmup_constant(lr: float, warmup: int) -> Callable[[int], float]:
    """``optax.join_schedules([linear_schedule(0, lr, n),
    constant_schedule(lr)], [n])`` with n = max(warmup, 1), in optax's f32
    arithmetic: ``(0 - lr) * (1 - count / n) + lr`` below n. Adam reads it
    at its count before the increment, so the first update has lr 0."""
    n = max(warmup, 1)

    def schedule(count: int) -> float:
        if count < n:
            frac = _F32(1) - _F32(count) / _F32(n)
            return float(_F32(-lr) * frac + _F32(lr))
        return float(_F32(lr))

    return schedule


def make_optimizer(params, lr: float, warmup: int, clip: float,
                   weight_decay: float = 0.01) -> Optimizer:
    """``lgm_tpu``'s finetune chain: ``clip_by_global_norm(clip)``, then
    ``adamw(warmup_constant(lr, warmup), b1=0.9, b2=0.999, eps=1e-8,
    weight_decay, mu_dtype=bf16)``."""
    return Optimizer(params, AdamW(warmup_constant(lr, warmup), clip,
                                   b2=0.999, weight_decay=weight_decay))


def diffusion_loss(unet, batch: Dict[str, torch.Tensor],
                   alphas_cumprod: torch.Tensor, ip: bool) -> torch.Tensor:
    """Epsilon MSE over the noisy content frames.

    batch: latents / noise [B, F, 4, h, w] f32, t [B], context [B, L, C],
    camera [B, Ft, 16]; the ImageDream path adds ip_feats [B, Np, Dv] and
    ip_img [B, 4, h, w]."""
    lat, noise, t = batch["latents"], batch["noise"], batch["t"]
    B, F = lat.shape[:2]
    a = alphas_cumprod[t].view(B, 1, 1, 1, 1)
    x_t = torch.sqrt(a) * lat + torch.sqrt(1.0 - a) * noise
    Ft = F + 1 if ip else F
    if ip:
        # The placeholder frame, where the U-Net puts the clean reference
        # latent.
        x_t = torch.cat([x_t, torch.zeros_like(x_t[:, :1])], dim=1)
    kw = {}
    if ip:
        kw = dict(ip=batch["ip_feats"].repeat_interleave(Ft, dim=0),
                  ip_img=batch["ip_img"])
    eps = unet(x_t.reshape(B * Ft, *x_t.shape[2:]), t.repeat_interleave(Ft),
               batch["context"].repeat_interleave(Ft, dim=0), Ft,
               camera=batch["camera"].reshape(B * Ft, 16), **kw)
    eps = eps.reshape(B, Ft, *eps.shape[1:])[:, :F]
    return ((eps.float() - noise.float()) ** 2).mean()


def ema_decay_at(decay: float, step: int) -> float:
    """The EMA's decay at ``step`` (the count before this step's
    increment), in f32: min(decay, (1 + s) / (10 + s))."""
    s = _F32(step)
    return float(min(_F32(decay), (_F32(1) + s) / (_F32(10) + s)))


@torch.no_grad()
def update_ema(ema: List[torch.Tensor], params, decay: float,
               step: int) -> None:
    """``ema * d + p * (1 - d)`` in f32, in place."""
    d = ema_decay_at(decay, step)
    rest = float(_F32(1) - _F32(d))
    for e, p in zip(ema, params):
        e.mul_(d).add_(p.detach().float() * rest)


def train_step(unet, optimizer: Optimizer, ema: Optional[List[torch.Tensor]],
               batch: Dict[str, torch.Tensor], step: int,
               alphas_cumprod: torch.Tensor, ip: bool,
               ema_decay: float = 0.0) -> Dict[str, torch.Tensor]:
    """One step on a prepared batch: the loss and its gradient (averaged
    over the ranks when ``unet`` is a DistributedDataParallel), the
    optimizer's update, the EMA at ``step``. Returns the loss and the
    norm of the raw gradient as 0-d tensors."""
    params = optimizer.params
    for p in params:
        p.grad = None
    loss = diffusion_loss(unet, batch, alphas_cumprod, ip)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    gnorm = global_norm(grads)
    optimizer.update(grads, gnorm)
    for p in params:
        p.grad = None
    if ema is not None and ema_decay > 0.0:
        update_ema(ema, params, ema_decay, step)
    return {"loss": loss.detach(), "gnorm": gnorm}


class DiffusionTrainer:
    """Host-side orchestration: the frozen encoders, the host draws, the
    step, the EMA, checkpoints and the export. ``world`` is the process's
    place among the ranks (one process by default)."""

    def __init__(self, pipe: MVDreamPipeline, lr: float = 1e-5,
                 warmup: int = 100, grad_clip: float = 1.0, cond_drop: float = 0.1,
                 seed: int = 0, world: Optional[dist.World] = None,
                 ema_decay: float = 0.9999):
        self.pipe = pipe
        self.device = pipe.device
        self.ip = pipe.cfg.ip_dim > 0
        self.cond_drop = cond_drop
        self.ema_decay = ema_decay
        self.rng = np.random.default_rng(seed)
        self.world = world or dist.World(device=self.device)
        for name, module in pipe.modules().items():
            module.requires_grad_(name == "unet")
        self.unet = pipe.unet
        self.names = [n for n, _ in self.unet.named_parameters()]
        self.optimizer = make_optimizer(self.unet.parameters(), lr, warmup,
                                        grad_clip)
        # The EMA shadow of the U-Net weights (ema_decay 0 keeps none, and
        # the export then writes the raw weights).
        self.ema = ([p.detach().clone() for p in self.optimizer.params]
                    if ema_decay > 0.0 else None)
        self.model = self.unet
        if self.world.distributed:
            # Gradients are averaged over the ranks in the backward; the
            # wrapper first broadcasts rank 0's parameters.
            from torch.nn.parallel import DistributedDataParallel

            dev = self.device
            self.model = DistributedDataParallel(
                self.unet, device_ids=[dev.index] if dev.type == "cuda"
                else None)
        self.alphas_cumprod = torch.as_tensor(
            pipe.scheduler.alphas_cumprod, dtype=torch.float32,
            device=self.device)
        self._prompt_cache: Dict[str, torch.Tensor] = {}
        # The null conditioning of CFG dropout (the sampler's negative
        # branch).
        self._null_ctx = self._encode_prompt("")
        self.step = 0

    # -- frozen encoders ------------------------------------------------
    def _encode_prompt(self, text: str) -> torch.Tensor:
        """The prompt's CLIP context [L, C] (f32, on the device), cached;
        a normal tensor (the pipeline's are inference tensors, which
        autograd cannot save)."""
        if text not in self._prompt_cache:
            self._prompt_cache[text] = self.pipe.encode_prompt(text)[1][0] \
                .clone()
        return self._prompt_cache[text]

    @torch.no_grad()
    def _vae_sample(self, images: np.ndarray, eps: np.ndarray
                    ) -> torch.Tensor:
        """images [N, S, S, 3] in [0, 1], eps [N, h, w, 4] -> the sampled,
        scaled latents [N, 4, h, w] in f32."""
        dev = self.device
        x = torch.as_tensor(np.ascontiguousarray(
            images.transpose(0, 3, 1, 2)), device=dev) * 2.0 - 1.0
        mean, logvar = self.pipe.vae.encode(x)
        z = mean + torch.exp(0.5 * logvar) * torch.as_tensor(
            np.ascontiguousarray(eps.transpose(0, 3, 1, 2)), device=dev)
        return (z * SCALING_FACTOR).float()

    # -- one step -------------------------------------------------------
    def prepare_batch(self, data: Dict) -> Dict[str, torch.Tensor]:
        """Host batch {images [B, F, S, S, 3], camera [B, F, 16], prompts}
        of the whole (global) batch -> this rank's slice on the device,
        NCHW: latents / noise [b, F, 4, h, w], t [b], context [b, L, C],
        camera [b, Ft, 16], and on the ImageDream path ip_feats and ip_img
        [b, 4, h, w]."""
        images = np.asarray(data["images"], np.float32)
        B, F = images.shape[:2]
        dp = self.world.dp
        assert B % dp == 0, (
            f"batch of {B} scenes is not divisible by the dp ranks ({dp}); "
            f"pass a multiple")
        # The host draws of the global batch, in lgm_tpu's order and
        # (NHWC) shapes. VAE downsample factor: one 2x per extra encoder
        # block (8 for the SD VAE).
        ds = 2 ** (len(self.pipe.cfg.vae_channels) - 1)
        h, w = images.shape[2] // ds, images.shape[3] // ds
        eps = self.rng.standard_normal((B * F, h, w, 4)).astype(np.float32)
        drop = self.rng.random(B) < self.cond_drop
        noise = self.rng.standard_normal((B, F, h, w, 4)).astype(np.float32)
        t = self.rng.integers(0, self.pipe.scheduler.num_train_timesteps, B)

        n = B // dp
        mine = slice(self.world.dp_rank * n, (self.world.dp_rank + 1) * n)
        dev = self.device
        lat = self._vae_sample(
            images[mine].reshape((n * F,) + images.shape[2:]),
            eps.reshape(B, F, h, w, 4)[mine].reshape(n * F, h, w, 4))
        lat = lat.reshape(n, F, *lat.shape[1:])
        prompts = list(data["prompts"])[mine]
        ctx = torch.stack([
            self._null_ctx if d else self._encode_prompt(p)
            for d, p in zip(drop[mine], prompts)])
        cam = torch.as_tensor(np.asarray(data["camera"], np.float32)[mine],
                              device=dev)
        batch = {
            "latents": lat,
            "noise": torch.as_tensor(noise[mine].transpose(0, 1, 4, 2, 3),
                                     device=dev).contiguous(),
            "t": torch.as_tensor(t[mine], device=dev),
            "context": ctx,
        }
        if self.ip:
            # Frame 0 is the reference image: its CLIP features and its
            # clean latent (unscaled); a zero conditioning row for the
            # extra frame. Dropped scenes get the sampler's null (zeros).
            feats = []
            for i in range(mine.start, mine.stop):
                f = self.pipe.encode_image(images[i, 0])[1][0].clone()
                feats.append(torch.zeros_like(f) if drop[i] else f)
            keep = torch.as_tensor(~drop[mine], device=dev)
            ip_img = lat[:, 0] / torch.tensor(SCALING_FACTOR, device=dev)
            batch["ip_feats"] = torch.stack(feats)
            batch["ip_img"] = torch.where(keep[:, None, None, None], ip_img,
                                          torch.zeros_like(ip_img))
            cam = torch.cat([cam, torch.zeros_like(cam[:, :1])], dim=1)
        batch["camera"] = cam
        return batch

    def train_step(self, data: Dict) -> Dict[str, torch.Tensor]:
        """``prepare_batch`` and one step; the loss is this rank's slice's
        (``dist.reduce_metrics`` gives the global batch's)."""
        batch = self.prepare_batch(data)
        metrics = train_step(self.model, self.optimizer, self.ema, batch,
                             self.step, self.alphas_cumprod, self.ip,
                             self.ema_decay)
        self.step += 1
        return metrics

    # -- persistence ----------------------------------------------------
    def state_dict(self) -> Dict:
        """``{"unet", "opt_state", "ema", "step"}``: the U-Net's state
        dict, Adam's count and moments and the EMA keyed by parameter name
        (no "ema" without a shadow)."""
        opt = self.optimizer.state_dict()
        state = {"unet": self.unet.state_dict(),
                 "opt_state": {"count": opt["count"],
                               "mu": dict(zip(self.names, opt["mu"])),
                               "nu": dict(zip(self.names, opt["nu"]))},
                 "step": self.step}
        if self.ema is not None:
            state["ema"] = dict(zip(self.names, self.ema))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """The inverse of ``state_dict`` (tensors on any device; an "ema"
        is ignored without a shadow, and its absence leaves the shadow)."""
        self.unet.load_state_dict(state["unet"])
        opt = state["opt_state"]
        self.optimizer.load_state_dict({
            "count": opt["count"], "mini_step": 0,
            "mu": [opt["mu"][n] for n in self.names],
            "nu": [opt["nu"][n] for n in self.names]})
        if self.ema is not None and "ema" in state:
            for e, n in zip(self.ema, self.names):
                e.copy_(state["ema"][n])
        self.step = int(state["step"])

    def save(self, workspace: str) -> str:
        """``<workspace>/dckpt_{step}``, written by rank 0 (every rank
        calls it)."""
        path = os.path.abspath(os.path.join(workspace, f"dckpt_{self.step}"))
        if self.world.is_lead:
            os.makedirs(workspace, exist_ok=True)
            tmp = path + ".tmp"
            torch.save(self.state_dict(), tmp)
            os.replace(tmp, path)
        dist.barrier(self.world)
        return path

    def restore(self, path: str) -> None:
        self.load_state_dict(torch.load(path, map_location="cpu",
                                        weights_only=True, mmap=True))

    def export(self, path: str, use_ema: bool = True) -> None:
        """A pipeline directory (``save_pretrained``) with the finetuned
        U-Net: the EMA shadow by default (the weights one samples from),
        else or without one the raw weights. Rank 0 writes."""
        if self.world.is_lead:
            unet = None
            if use_ema and self.ema is not None:
                unet = dict(self.unet.state_dict())
                unet.update(zip(self.names, self.ema))
            self.pipe.save_pretrained(path, state_dicts={"unet": unet})
        dist.barrier(self.world)


def make_dataset(args, device):
    from lgm_tpu_torch.diffusion.data import LVISMVData, SyntheticMVData

    if args.data_mode == "synthetic":
        return SyntheticMVData(num_frames=args.num_frames,
                               image_size=args.image_size, device=device)
    return LVISMVData(args.data_path, num_frames=args.num_frames,
                      image_size=args.image_size)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Finetune the multi-view diffusion U-Net")
    ap.add_argument("--pipeline", default="mvdream",
                    help="config name (mvdream/imagedream/tiny-test)")
    ap.add_argument("--ckpt", default=None,
                    help="diffusers-layout pipeline dir (from_pretrained)")
    ap.add_argument("--tokenizer", default=None,
                    help="CLIP BPE tokenizer dir (vocab.json, merges.txt) "
                         "for a pipeline from its config (no --ckpt)")
    ap.add_argument("--workspace", default="workspace_diffusion")
    ap.add_argument("--data-mode", default="synthetic",
                    choices=["synthetic", "lvis"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--batch-size", type=int, default=4,
                    help="scenes per step, over all ranks")
    ap.add_argument("--num-frames", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=10000)
    ap.add_argument("--cond-drop", type=float, default=0.1)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--ema-decay", type=float, default=0.9999,
                    help="EMA decay for the exported weights (0 disables)")
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--export", default=None,
                    help="write a pipeline dir at the end")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    world = dist.init_world(1, resolve_device(args.device))
    dev = world.device
    logger = None
    try:
        lead = world.is_lead
        os.makedirs(args.workspace, exist_ok=True)
        if args.ckpt:
            pipe = MVDreamPipeline.from_pretrained(args.ckpt, device=str(dev))
        else:
            from lgm_tpu_torch.diffusion.pipeline import CONFIGS
            from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer

            tok = (CLIPTokenizer(args.tokenizer,
                                 CONFIGS[args.pipeline].max_tokens)
                   if args.tokenizer else None)
            pipe = MVDreamPipeline.from_config(args.pipeline,
                                               device=str(dev), tokenizer=tok)
        trainer = DiffusionTrainer(
            pipe, lr=args.lr, warmup=args.warmup_steps,
            grad_clip=args.grad_clip,
            cond_drop=args.cond_drop, ema_decay=args.ema_decay, world=world)
        if args.resume:
            trainer.restore(args.resume)
        if lead:
            from lgm_tpu_torch.utils.logging import MetricLogger

            logger = MetricLogger(args.workspace)
        ds = make_dataset(args, dev)
        t_last = time.time()
        while trainer.step < args.total_steps:
            data = ds.batch(trainer.step, args.batch_size)
            metrics = trainer.train_step(data)
            s = trainer.step
            if s % 50 == 0 or s == 1:
                m = dist.reduce_metrics(world, metrics)
                dt = time.time() - t_last
                t_last = time.time()
                if lead:
                    logger.log(s, m, prefix="diffusion")
                    print(f"step {s}: loss {m['loss']:.4f} "
                          f"({dt:.1f}s/50it)", flush=True)
            if s % args.save_every == 0 or s == args.total_steps:
                path = trainer.save(args.workspace)
                if lead:
                    print(f"saved {path}", flush=True)
        if args.export:
            trainer.export(args.export)
            if lead:
                print(f"exported pipeline to {args.export}", flush=True)
    finally:
        if logger is not None:
            logger.close()
        dist.close(world)


if __name__ == "__main__":
    main()
