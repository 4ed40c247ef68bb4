#!/usr/bin/env python3
"""Time K1 and K1ᵇ on the two tensor-core routes of Hopper: the package's
kernels (mma.sync fed by ldmatrix, ``lgm_tpu_torch/ops/csrc/mha_*.cu``)
and this probe's (wgmma, ``mha_wgmma.cu``), beside SDPA.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python3 scripts/mha_wgmma/run.py [--out chiprun_out/mha_wgmma.jsonl]

It builds the probe with nvcc for sm_90a into ``build/mha_wgmma/``, prints
each probe kernel's registers and spills from ``ptxas -v``, then for each
(BH, S, D) of LGM-big's attention sites holds the probe's outputs against
the plain versions (``K1_REL_TOL`` of ``chip_smoke.py``) and prints one
JSON line per route and block: device ms per call (median of 10 samples
of 10 calls back to back, CUDA events), with SDPA's forward and backward
on the same inputs. The card's name and power limit end the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SHAPES = [(16, 4096, 32), (16, 1024, 64), (16, 256, 64),
          (32, 4096, 32), (32, 1024, 64), (32, 256, 64)]


def build() -> tuple:
    out_dir = os.path.join(ROOT, "build", "mha_wgmma")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "mha_wgmma.so")
    cmd = ["/usr/local/cuda/bin/nvcc", "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-I", os.path.join(ROOT, "lgm_tpu_torch", "ops", "csrc"),
           "-o", so, os.path.join(HERE, "mha_wgmma.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    return so, res.stdout + res.stderr


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
        print("mha_wgmma: no CUDA device", file=sys.stderr)
        return 1
    out = open(args.out, "w") if args.out else None

    def emit(**fields):
        line = json.dumps(fields)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    so, log = build()
    emit(ptxas=chip_smoke.ptxas_summary(log))
    lib = ctypes.CDLL(so)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wg_mha_fwd.argtypes = [P] * 5 + [I] * 3 + [Fl, I, P]
    lib.wg_mha_bwd.argtypes = [P] * 10 + [I] * 3 + [Fl, I, P]
    lib.wg_mha_fwd.restype = lib.wg_mha_bwd.restype = I
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_ms(fn):
        return chip_smoke.cuda_ms(fn, launches=10)

    def rel_err(ours, ref):
        return float((ours.float() - ref.float()).abs().max()) / float(
            ref.float().abs().max())

    for BH, S, D in SHAPES:
        rng = np.random.default_rng(S + D)
        q, k, v, do = (torch.as_tensor(rng.normal(0, 1, (BH, S, D)),
                                       dtype=torch.float32, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(D) ** -0.5
        with torch.no_grad():
            ref, ref_lse = mha_mod.mha_reference(q, k, v, scale, True)
            ref_grads = mha_mod.mha_bwd_reference(q, k, v, ref, do, scale,
                                                  ref_lse)
            sdpa = device_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale))
            pkg = device_ms(lambda: mha_mod.mha_fwd(q, k, v, scale, True))
            pkg_b = device_ms(lambda: mha_mod.mha_bwd(q, k, v, ref, do,
                                                      scale, ref_lse))
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        y = F.scaled_dot_product_attention(qs[None], ks[None], vs[None],
                                           scale=scale)
        sdpa_b = device_ms(lambda: torch.autograd.grad(
            y, (qs, ks, vs), do[None], retain_graph=True))
        del y, qs, ks, vs
        emit(route="mma.sync", shape=[BH, S, D], fwd_ms=pkg, bwd_ms=pkg_b,
             sdpa_ms=sdpa, sdpa_bwd_ms=sdpa_b)
        o = torch.empty_like(q)
        lse = torch.empty(BH, S, dtype=torch.float32, device=dev)
        grads = [torch.empty_like(q) for _ in range(3)]
        drow = torch.empty(BH, S, dtype=torch.float32, device=dev)
        for nwg in (1, 2, 4):
            def f():
                return lib.wg_mha_fwd(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), o.data_ptr(),
                                      lse.data_ptr(), BH, S, D, scale, nwg,
                                      stream)

            def b():
                return lib.wg_mha_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), ref.data_ptr(),
                    do.data_ptr(), ref_lse.data_ptr(),
                    *(g.data_ptr() for g in grads), drow.data_ptr(), BH, S,
                    D, scale, nwg, stream)

            if f() or b():
                continue  # S not a multiple of this block's rows
            torch.cuda.synchronize()
            errs = dict(o=rel_err(o, ref),
                        lse=float((lse - ref_lse).abs().max()),
                        **{n: rel_err(g, r) for n, g, r in
                           zip(("dq", "dk", "dv"), grads, ref_grads)})
            if not max(errs["o"], errs["dq"], errs["dk"], errs["dv"]) \
                    <= chip_smoke.K1_REL_TOL:
                raise AssertionError(f"wgmma probe {BH}x{S}x{D} nwg {nwg}: "
                                     f"{errs}")
            emit(route="wgmma", shape=[BH, S, D], warpgroups=nwg,
                 fwd_ms=device_ms(f), bwd_ms=device_ms(b), sdpa_ms=sdpa,
                 sdpa_bwd_ms=sdpa_b, rel_err=errs)
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
