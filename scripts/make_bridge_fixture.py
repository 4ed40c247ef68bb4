"""Write ``tests/fixtures/bridge/``: a checkpoint of lgm_tpu converted into
the port's, and what lgm_tpu computes from it.

lgm_tpu's trainer at ``nano`` in f32 (with its exact renderer, the
``xla`` rasterizer, which the port's ``reference`` backend mirrors) takes
one step on a seeded synthetic batch and saves ``ckpt_1`` with its own
``save_checkpoint`` (orbax);
``scripts/ckpt_to_torch.py`` converts it into the port's ``ckpt_1``.
``reference.npz`` holds the batch, lgm_tpu's Gaussians for its input from
the checkpointed parameters, the background of the next step and that
step's loss terms and gradient norm. ``chip_smoke.py`` (phase ``bridge``)
loads the converted file on the card and holds the port to them; this
script prints the port's errors on the CPU beside them.

Needs JAX. Run: python scripts/make_bridge_fixture.py [--out DIR]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "bridge")
FLAGS = ["nano", "--mixed-precision", "fp32"]
METRICS = ("loss", "loss_mse", "psnr", "gnorm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from lgm_tpu import train as jtrain
    from lgm_tpu.config import parse_cli as jparse
    from lgm_tpu.data.synthetic import make_batch
    from lgm_tpu.models.lgm import LGM as JaxLGM

    jopt = jparse(FLAGS)
    batch = make_batch(np.random.default_rng(0), jopt,
                       batch_size=jopt.batch_size, n_gaussians=256)
    data = {k: np.asarray(v, np.float32) for k, v in batch.items()
            if k != "scenes"}
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    state, _ = jtrain.create_state(jopt, jax.random.PRNGKey(0), jdata,
                                   backend="xla")
    step = jax.jit(jtrain.train_step)
    state, _ = step(state, jdata, jax.random.PRNGKey(10))
    gaussians = JaxLGM(jopt, dtype=jnp.float32).apply(
        {"params": state.params["lgm"]}, jdata["input"])
    key = jax.random.PRNGKey(11)
    bg = np.asarray(jax.random.uniform(key, (3,)), np.float32)

    tmp = tempfile.mkdtemp()
    try:
        src = jtrain.save_checkpoint(os.path.join(tmp, "jax"), state, 1)
        spec = importlib.util.spec_from_file_location(
            "ckpt_to_torch", os.path.join(ROOT, "scripts",
                                          "ckpt_to_torch.py"))
        conv = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(conv)
        os.makedirs(args.out, exist_ok=True)
        path = conv.main([*FLAGS, "--ckpt", src, "--out", args.out])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _, metrics = step(state, jdata, key)
    ref = dict(data, gaussians=np.asarray(gaussians, np.float32), bg=bg,
               **{k: np.float32(metrics[k]) for k in METRICS})
    np.savez(os.path.join(args.out, "reference.npz"), **ref)

    # The port on the CPU from the converted file, as the card runs it.
    import torch

    from lgm_tpu_torch import infer, train
    from lgm_tpu_torch.config import parse_cli

    opt = parse_cli(FLAGS)
    model = infer.load_model(opt, path, "cpu")
    with torch.no_grad():
        g = model(torch.as_tensor(data["input"])).numpy()
    tstate = train.load_checkpoint(path, train.create_state(
        opt, "cpu", backend="reference"))
    m = train.train_step(tstate, {k: torch.as_tensor(v)
                                  for k, v in data.items()},
                         torch.as_tensor(bg))
    print(f"wrote {path} ({os.path.getsize(path)} bytes) and "
          f"reference.npz; port on the CPU: gaussians max abs err "
          f"{np.abs(g - ref['gaussians']).max():.3g}; " + ", ".join(
              f"{k} {float(m[k]):.7g} vs {float(ref[k]):.7g}"
              for k in METRICS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
