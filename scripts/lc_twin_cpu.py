"""lgm_tpu's and the port's trainers side by side on the CPU: a learning
curve of each from the same command-line flags, for fault C7 (ROADMAP §C).

Both CLIs (``python -m lgm_tpu.train`` with ``JAX_PLATFORMS=cpu``, and
``python -m lgm_tpu_torch.train --device cpu``) run the same preset and
flags on synthetic scenes, at the same time, in their own workspaces under
``--out``; the plain PyTorch paths run in the port (no kernel). The
script then prints, for each, the eval PSNR at every eval and the mean
logged train loss over each 500 steps, as one JSON line, and writes
it to ``<out>/compare.json``. By default (``--port-init torch``) the two
start from their own random weights, each drawn by its own framework
from flax's initialisers (the port's through ``models/init.py``), so a
pair is one draw of each; ``--port-init lgm_tpu`` starts the port
from lgm_tpu's initial weights instead (its ``create_state`` under
``PRNGKey(42)``, through ``weights.flax_params_to_state_dict``, saved as
the port's ``ckpt_0`` and passed as ``--resume``).

Needs JAX (lgm_tpu's side). Run:
    python scripts/lc_twin_cpu.py [--out build/lc_twin] [--preset nano]
        [--threads 4] [--port-init torch|lgm_tpu] -- --batch-size 4
        --lr 2e-4 --warmup-steps 200 --total-steps 2000 --eval-every 500
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def summary(path: str) -> dict:
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    train = [r for r in rows if "train/loss" in r]
    windows = {}
    for r in train:
        w = (r["step"] - 1) // 500 * 500
        windows.setdefault(w, []).append(r["train/loss"])
    return {"eval_psnr": {r["step"]: r["eval/psnr"] for r in rows
                          if "eval/psnr" in r},
            "train_loss_by_500": {w: sum(v) / len(v)
                                  for w, v in sorted(windows.items())},
            "final_gnorm": train[-1]["train/gnorm"] if train else None}


def lgm_tpu_init_checkpoint(preset: str, flags: list, ws: str) -> str:
    """The port's ``ckpt_0`` holding lgm_tpu's initial LGM weights for
    ``preset`` with ``flags`` (and the port's own fresh optimizer)."""
    import jax
    import jax.numpy as jnp

    from lgm_tpu import train as jtrain
    from lgm_tpu.config import parse_cli as jparse
    from lgm_tpu_torch import train as ttrain
    from lgm_tpu_torch.config import parse_cli as tparse
    from lgm_tpu_torch.weights import (flax_params_to_state_dict,
                                       load_state_dict_into)

    jax.config.update("jax_platforms", "cpu")
    jopt = jparse([preset, *flags])
    train_ds, _ = jtrain.make_datasets(jopt)
    sample = {k: jnp.asarray(v) for k, v in train_ds.batch(0).items()
              if k != "scenes"}
    jstate, _ = jtrain.create_state(jopt, jax.random.PRNGKey(42), sample)
    tstate = ttrain.create_state(tparse([preset, *flags]), "cpu")
    sd = flax_params_to_state_dict(jstate.params)   # LGMWithLoss's: lgm.*
    load_state_dict_into(tstate.model.lgm, {
        k[len("lgm."):]: v for k, v in sd.items() if k.startswith("lgm.")})
    os.makedirs(ws, exist_ok=True)
    return ttrain.save_checkpoint(ws, tstate, 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "lc_twin"))
    ap.add_argument("--preset", default="nano")
    ap.add_argument("--threads", default="4")
    ap.add_argument("--port-init", choices=["torch", "lgm_tpu"],
                    default="torch")
    ap.add_argument("flags", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    flags = [f for f in args.flags if f != "--"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=args.threads,
               JAX_PLATFORMS="cpu")
    runs = {
        "lgm_tpu": [sys.executable, "-m", "lgm_tpu.train", args.preset,
                    *flags, "--workspace", os.path.join(args.out, "lgm_tpu")],
        "port": [sys.executable, "-m", "lgm_tpu_torch.train", args.preset,
                 *flags, "--device", "cpu", "--workspace",
                 os.path.join(args.out, "port")],
    }
    if args.port_init == "lgm_tpu":
        runs["port"] += ["--resume", lgm_tpu_init_checkpoint(
            args.preset, flags, os.path.join(args.out, "port"))]
    t0 = time.time()
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                    stdout=subprocess.DEVNULL)
             for name, cmd in runs.items()}
    rcs = {name: p.wait() for name, p in procs.items()}
    out = {"flags": [args.preset, *flags], "port_init": args.port_init,
           "rcs": rcs,
           "wall_s": time.time() - t0}
    for name in runs:
        path = os.path.join(args.out, name, "metrics.jsonl")
        if os.path.exists(path):
            out[name] = summary(path)
    with open(os.path.join(args.out, "compare.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0 if all(rc == 0 for rc in rcs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
