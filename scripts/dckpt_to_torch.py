"""Convert a diffusion finetune checkpoint of lgm_tpu into the port's.

``lgm_tpu.diffusion.train`` saves its state (U-Net parameters, the optax
state, the EMA shadow, the step) as an orbax checkpoint ``dckpt_N``;
``lgm_tpu_torch.diffusion.train`` reads ``torch.save`` files of the same
state under the port's names. This script restores the orbax checkpoint
through lgm_tpu's own trainer (so it needs JAX, and runs where lgm_tpu
runs) and writes the port's file, which ``--resume`` continues from:

    python scripts/dckpt_to_torch.py --pipeline mvdream \\
        --dckpt ws/dckpt_5000 --out ws_torch/dckpt_5000 [--ckpt DIR]
    python -m lgm_tpu_torch.diffusion.train --pipeline mvdream \\
        --ckpt DIR_TORCH --resume ws_torch/dckpt_5000 ...

``--pipeline`` / ``--ckpt`` give the checkpoint's architecture as
``lgm_tpu.diffusion.train`` was given it; ``--ema-decay 0`` for a run
that kept no EMA shadow.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pipeline", default="mvdream")
    ap.add_argument("--ckpt", default=None,
                    help="the converted pipeline dir the run started from")
    ap.add_argument("--dckpt", required=True,
                    help="lgm_tpu's orbax dckpt_N directory")
    ap.add_argument("--out", required=True, help="the port's dckpt_N file")
    ap.add_argument("--ema-decay", type=float, default=0.9999)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    import torch

    from lgm_tpu.diffusion.pipeline import MVDreamPipeline
    from lgm_tpu.diffusion.train import DiffusionTrainer
    from lgm_tpu_torch.weights import diffusion_train_state_to_torch

    if args.ckpt:
        pipe = MVDreamPipeline.from_pretrained(args.ckpt, name=args.pipeline)
    else:
        pipe = MVDreamPipeline.from_config(args.pipeline)
    trainer = DiffusionTrainer(pipe, num_devices=1, ema_decay=args.ema_decay)
    trainer.restore(args.dckpt)
    state = {"unet": jax.device_get(trainer.params),
             "opt_state": jax.device_get(trainer.opt_state),
             "step": trainer.step}
    if trainer.ema_params is not None:
        state["ema"] = jax.device_get(trainer.ema_params)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(diffusion_train_state_to_torch(state), args.out)
    print(f"wrote {args.out} (step {trainer.step})")
    return args.out


if __name__ == "__main__":
    main()
