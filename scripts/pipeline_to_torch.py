"""Convert a diffusion pipeline directory of lgm_tpu into the port's.

``lgm_tpu``'s ``MVDreamPipeline.save_pretrained`` (also
``lgm_tpu.tools.convert_diffusion`` and ``lgm_tpu.diffusion.train
--export``) writes ``config.json`` (its ``PipelineConfig``), an orbax
checkpoint ``params/`` of the four components' Flax trees and, where
there is one, the CLIP vocabulary under ``tokenizer/``. The port's
``MVDreamPipeline.from_pretrained`` reads the diffusers layout instead
(``unet/ vae/ text_encoder/ image_encoder/ tokenizer/``, each
``config.json`` and weights). This script restores the orbax tree (so it
needs JAX, and runs where lgm_tpu runs), maps it through
``weights.diffusion_params_to_state_dicts``, loads it strictly into the
port's pipeline of the same config on the CPU and writes that with the
port's ``save_pretrained``:

    python scripts/pipeline_to_torch.py lgm_tpu_dir out_dir
    python -m lgm_tpu_torch.infer big --image x.png --diffusion-ckpt out_dir
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="lgm_tpu's pipeline directory")
    ap.add_argument("out", help="the port's diffusers-layout directory")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    from lgm_tpu_torch.diffusion.pipeline import (MVDreamPipeline,
                                                  PipelineConfig)
    from lgm_tpu_torch.diffusion.tokenizer import load_tokenizer
    from lgm_tpu_torch.weights import diffusion_params_to_state_dicts

    jax.config.update("jax_platforms", "cpu")
    with open(os.path.join(args.src, "config.json")) as fh:
        raw = json.load(fh)
    known = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = sorted(set(raw) - known)
    if unknown:
        raise KeyError(f"config.json fields the port does not know: "
                       f"{unknown}")
    config = PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in raw.items()})
    params = ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(args.src, "params")))
    sds = diffusion_params_to_state_dicts(jax.tree_util.tree_map(
        np.asarray, params))
    pipe = MVDreamPipeline(config, device="cpu", tokenizer=load_tokenizer(
        args.src, config.max_tokens))
    missing = sorted(set(pipe.modules()) - set(sds))
    if missing:
        raise KeyError(f"components missing from {args.src}: {missing}")
    pipe.load_state_dicts(sds)
    pipe.save_pretrained(args.out)
    print(f"wrote {args.out} ({', '.join(sorted(sds))})")
    return args.out


if __name__ == "__main__":
    main()
