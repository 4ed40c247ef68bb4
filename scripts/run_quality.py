"""The port's quality evidence on one card, written to ``quality/``.

1. The learning curve of BENCHMARKS.md's "Round 5 learning curves"
   protocol: ``python -m lgm_tpu_torch.train small --batch-size 4 --lr
   2e-4 --warmup-steps 200 --total-steps 2000 --rasterizer-dup 32
   --eval-every 1000`` on synthetic scenes, every other field at the
   ``small`` preset. Its ``metrics.jsonl`` is copied to
   ``learning_curve_h100_r5_dup32.jsonl``; the reference is
   ``benchmarks/learning_curve_r5_dup32.jsonl``.
2. ``scripts/eval_convert_quality_torch.py`` at the ``reference`` budget
   on the torus and the cross, rows appended to
   ``convert_quality_h100.jsonl``; the reference rows are the last two of
   ``benchmarks/convert_quality_torus.jsonl``.

The trainer starts from flax's initialisers, as lgm_tpu's does
(``lgm_tpu_torch/models/init.py``). An earlier run that re-drew the
weights so, from a trainer that started from PyTorch's, is kept as
``learning_curve_h100_r5_dup32_flax_init.jsonl`` and
``summary_flax_init.json``.

``summary.json`` gets each run's wall seconds, the training's steps/s
(from the logged timestamps of step 100 and the last step: the steps
between, evals and checkpoints included, over the time between), the eval
PSNR at each eval, and the card's name and power limit; sections that a
run does not make are kept from the file already there. The trainer's
workspace (its checkpoints) stays under ``build/quality``.
``--stop-after-s`` cuts the learning curve short (to fit a call) and
records where it stopped.

Run on a card: python scripts/run_quality.py [--out quality]
                   [--only lc|convert] [--stop-after-s S]
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARGS = ["small", "--batch-size", "4", "--lr", "2e-4",
              "--warmup-steps", "200", "--total-steps", "2000",
              "--rasterizer-dup", "32", "--eval-every", "1000"]


def _run(cmd):
    t0 = time.time()
    subprocess.run(cmd, cwd=ROOT, check=True,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    return time.time() - t0


def learning_curve(out: str, stop_after_s: float = None) -> dict:
    ws = os.path.join(ROOT, "build", "quality", "lc")
    shutil.rmtree(ws, ignore_errors=True)
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "lgm_tpu_torch.train",
                             *TRAIN_ARGS,
                             "--workspace", ws, "--device", "cuda"],
                            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        rc = proc.wait(timeout=stop_after_s)
    except subprocess.TimeoutExpired:
        # The trainer saves and stops after its in-flight step on SIGTERM.
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
    else:
        if rc != 0:
            raise subprocess.CalledProcessError(rc, proc.args)
    wall = time.time() - t0
    dst = os.path.join(out, "learning_curve_h100_r5_dup32.jsonl")
    shutil.copy(os.path.join(ws, "metrics.jsonl"), dst)
    with open(dst) as fh:
        rows = [json.loads(line) for line in fh]
    train = {r["step"]: r for r in rows if "train/loss" in r}
    evals = {r["step"]: r["eval/psnr"] for r in rows if "eval/psnr" in r}
    shutil.rmtree(ws, ignore_errors=True)
    last = max(train)
    return {"wall_s": wall, "args": TRAIN_ARGS, "init": "flax",
            "stopped_at_step": None if last == 2000 else last,
            "steps_per_s": (last - 100) / (train[last]["ts"]
                                           - train[100]["ts"]),
            "eval_psnr": evals,
            "final_train_gnorm": train[last]["train/gnorm"],
            "final_train_loss": train[last]["train/loss"]}


def convert_quality(out: str) -> dict:
    dst = os.path.join(out, "convert_quality_h100.jsonl")
    walls = {}
    for shape in ("torus", "cross"):
        walls[shape] = _run([sys.executable, os.path.join(
            ROOT, "scripts", "eval_convert_quality_torch.py"), "--shape",
            shape, "--budget", "reference", "--device", "cuda", "--out",
            dst])
    return {"wall_s": walls}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "quality"))
    ap.add_argument("--only", choices=["lc", "convert"], default=None)
    ap.add_argument("--stop-after-s", type=float, default=None,
                    help="stop the learning curve (SIGTERM: the trainer "
                    "saves and exits) after this many seconds")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    path = os.path.join(args.out, "summary.json")
    summary = {}
    if os.path.exists(path):
        with open(path) as fh:
            summary = json.load(fh)
    if args.only in (None, "lc"):
        summary["learning_curve"] = dict(card=card, **learning_curve(
            args.out, args.stop_after_s))
    if args.only in (None, "convert"):
        summary["convert_quality"] = dict(card=card,
                                          **convert_quality(args.out))
    summary["card"] = card
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
        fh.write("\n")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
