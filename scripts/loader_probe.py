#!/usr/bin/env python3
"""Where a disk-data loader worker's time goes, on the host that feeds the
card: one training sample of LGM big (bs 8, 8 views, 512 out, 256 in) made
in one thread, alone and in N processes at once (the loader's workers),
and the cost of turning 8 samples into a batch in shared memory
(``np.stack`` then ``share_memory_``, against ``default_collate``'s stack
straight into shared memory, which ``data/provider.py::Loader`` uses).

Run from the root of a checkout, on a machine with a card (the dataset is
rendered there by ``chip_smoke.phase_disk_dataset`` into build/smoke/lvis,
unless ``--root`` names one):

    python3 scripts/loader_probe.py [--root DIR] [--procs 8]

Prints one JSON line a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One process: a sample a time, in one decode thread as a loader worker
# makes it, then the batch costs.
_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from torch.utils.data import default_collate
from torch.utils.data._utils import worker as _worker
from lgm_tpu_torch.config import CONFIGS
from lgm_tpu_torch.data import provider

provider._decode_threads = lambda n: 1
# (batch_size 1 only for the split: every scene but the last trains)
opt = CONFIGS["big"].replace(data_path_rendering=sys.argv[1], batch_size=1)
ds = provider.LVISDataset(opt, training=True)
ds[0]
t0 = time.perf_counter()
samples = [ds[i % len(ds)] for i in range(8)]
t1 = time.perf_counter()
batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
         for k in samples[0]}
for v in batch.values():
    v.share_memory_()
t2 = time.perf_counter()
# default_collate stacks into shared memory inside a loader worker.
_worker._worker_info = _worker.WorkerInfo(id=0, num_workers=1, seed=0,
                                          dataset=ds)
default_collate(samples)
t3 = time.perf_counter()
print(json.dumps({"sample_ms": (t1 - t0) / 8 * 1e3,
                  "stack_then_share_ms": (t2 - t1) * 1e3,
                  "collate_into_shared_ms": (t3 - t2) * 1e3}), flush=True)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=None)
    parser.add_argument("--procs", type=int, default=8)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    root = args.root
    if root is None:
        import torch

        import chip_smoke

        if not torch.cuda.is_available():
            print("loader_probe: no CUDA device to render the dataset on",
                  file=sys.stderr)
            return 1
        root = chip_smoke.phase_disk_dataset(torch.device("cuda", 0))
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(n):
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", _CHILD, root],
                                  stdout=subprocess.PIPE, text=True, env=env)
                 for _ in range(n)]
        outs = [json.loads(p.communicate()[0].strip().splitlines()[-1])
                for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("a probe process failed")
        return outs, time.perf_counter() - t0

    for n in (1, args.procs):
        outs, wall = run(n)
        print(json.dumps({"probe": "loader_worker", "processes": n,
                          "cpus": os.cpu_count(), "wall_s": wall,
                          **{k: sorted(o[k] for o in outs)
                             for k in outs[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
