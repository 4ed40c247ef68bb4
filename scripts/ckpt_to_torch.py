"""Convert a training checkpoint of lgm_tpu into the port's.

``lgm_tpu.train`` saves its full state (``LGMWithLoss``'s parameters, the
optax state, the step) as an orbax checkpoint ``ckpt_N``;
``lgm_tpu_torch.train`` reads ``torch.save`` files of the same state under
the port's names (``train.save_checkpoint``). This script restores the
orbax checkpoint against the state lgm_tpu's trainer builds for the same
preset and flags (so it needs JAX, and runs where lgm_tpu runs; any leaf
that does not match is an error) and writes ``<out>/ckpt_N``, which both
``--resume`` flags read:

    python scripts/ckpt_to_torch.py big --ckpt ws/ckpt_5000 --out ws_torch
        [any Options field as --flag, as the lgm_tpu run was given it]
    python -m lgm_tpu_torch.train big --workspace ws_torch --resume auto
    python -m lgm_tpu_torch.infer big --resume ws_torch/ckpt_5000 ...

The parameters go through ``weights.flax_params_to_state_dict``, the
optimizer state through ``weights.lgm_train_state_to_torch`` (Adam's
first moment stays bf16).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True,
                    help="lgm_tpu's orbax ckpt_N directory")
    ap.add_argument("--out", required=True,
                    help="the port's workspace; ckpt_N is written there")
    args, flags = ap.parse_known_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from lgm_tpu import train as jtrain
    from lgm_tpu.config import parse_cli as jparse
    from lgm_tpu.data.synthetic import make_batch
    from lgm_tpu_torch.config import parse_cli
    from lgm_tpu_torch.models.lgm import LGM
    from lgm_tpu_torch.weights import lgm_train_state_to_torch

    jax.config.update("jax_platforms", "cpu")
    jopt = jparse(flags)
    # The state's structure does not depend on the data: one synthetic
    # scene shapes the init.
    batch = make_batch(np.random.default_rng(0), jopt, batch_size=1,
                       n_gaussians=64)
    sample = {k: jnp.asarray(v) for k, v in batch.items() if k != "scenes"}
    # Shapes only: orbax restores into the abstract state's structure.
    jstate = jax.eval_shape(lambda: jtrain.create_state(
        jopt, jax.random.PRNGKey(0), sample)[0])
    target = {"params": jstate.params, "opt_state": jstate.opt_state,
              "step": 0}
    restored = ocp.StandardCheckpointer().restore(
        os.path.abspath(args.ckpt), target)
    opt = parse_cli(flags)
    with torch.device("meta"):
        names = [n for n, _ in LGM(opt).named_parameters()]
    ckpt = lgm_train_state_to_torch(jax.device_get(restored), names)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(os.path.abspath(args.out), f"ckpt_{ckpt['step']}")
    torch.save(ckpt, path)
    print(f"wrote {path} (step {ckpt['step']})")
    return path


if __name__ == "__main__":
    main()
