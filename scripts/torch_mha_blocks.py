#!/usr/bin/env python3
"""Time the mma design of the port's attention kernels K1 and K1ᵇ
(``csrc/mha_fwd.cu``, ``mha_bwd.cu``: D = 32) at every block shape they
are built for, at LGM-big's D-32 MVAttention sites, beside SDPA. (D = 64
takes the wgmma design, whose block is a number of consumer warpgroups:
``ops/mha.py::warpgroups``.)

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_mha_blocks.py [--out chiprun_out/mha_blocks.jsonl]

For each (BH, S, D) of one B = 1 forward and of the bs2 train step, it
prints one JSON line per block shape (m-tiles per warp, warps per block)
of K1 (with its row statistic), of K1ᵇ's dq kernel (its dK/dV kernel at
the default shape) and of K1ᵇ's dK/dV kernel (dq at the default): the
device time per call (median of 10 samples of 10 calls back to back, CUDA
events) and SDPA's on the same inputs (forward, or backward through
autograd). The shape that ``lgm_tpu_torch.ops.mha`` picks is marked
``chosen``. The card's name and power limit end the output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(16, 4096, 32), (32, 4096, 32)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from lgm_tpu_torch.ops import mha as mha_mod

    if not torch.cuda.is_available():
        print("torch_mha_blocks: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sms = mha_mod._sms(dev)
    out = open(args.out, "w") if args.out else None

    def emit(**fields):
        line = json.dumps(fields)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    def device_ms(fn):
        return chip_smoke.cuda_ms(fn, launches=10)

    # kernel -> the module attribute of its block-shape list
    lists = {"K1": "_FWD_BLOCKS", "K1b_dq": "_DQ_BLOCKS",
             "K1b_dkv": "_DKV_BLOCKS"}
    for BH, S, D in SHAPES:
        rng = np.random.default_rng(S + D)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(D) ** -0.5
        with torch.no_grad():
            sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale))
            o, lse = mha_mod.mha_fwd(q, k, v, scale, return_lse=True)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        ref = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                             scale=scale)
        sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(
            ref, (qs, ks, vs), do[None], retain_graph=True))
        del ref, qs, ks, vs
        for kernel, attr in lists.items():
            default = getattr(mha_mod, attr)
            chosen = mha_mod.block_shape(default, BH, S, sms)
            for shape in mha_mod._BUILT:
                setattr(mha_mod, attr, (shape,))
                with torch.no_grad():
                    if kernel == "K1":
                        ms = device_ms(lambda: mha_mod.mha_fwd(
                            q, k, v, scale, return_lse=True))
                        lib = sdpa_ms
                    else:
                        ms = device_ms(lambda: mha_mod.mha_bwd(
                            q, k, v, o, do, scale, lse))
                        lib = sdpa_bwd_ms
                setattr(mha_mod, attr, default)
                emit(kernel=kernel, shape=[BH, S, D], block=list(shape),
                     chosen=shape == chosen, ms=ms, sdpa_ms=lib,
                     over_sdpa=ms / lib)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if out:
        out.write(json.dumps({"card": smi.stdout.strip()}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
