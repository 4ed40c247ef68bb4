#!/usr/bin/env python3
"""Device times of K1 and K1ᵇ at LGM big's attention sites, for any
checkout: ``chip_smoke.py``'s phases ``k1`` (B = 1 and bs2, with the row
statistic) and ``k1_bwd`` (bs2), run from the tree at ``--root`` with
that tree's kernels, then one summary line. To compare two commits on
one card, run it for each in one call, in turns (old, new, new, old), the
older one an unpacked ``git archive`` in a directory ``.gitignore``
lists:

    python3 scripts/time_attention.py --root build/parent --tag parent
    python3 scripts/time_attention.py --tag change

Prints each phase's JSON lines and ``{"tag": ..., "k1_forward_ms": ...,
"k1b_step_ms": ...}`` (K1 over the 16 sites of a B = 1 forward, K1ᵇ over
those of a bs2 step). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ns = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(ns.root)
    sys.path.insert(0, root)
    import chip_smoke

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != root:
        raise RuntimeError(f"chip_smoke imported from outside {root}")
    from lgm_tpu_torch.ops import _build

    _build.build(["mha_fwd", "mha_bwd"])
    dev = torch.device("cuda", 0)
    k1 = chip_smoke.phase_k1(dev)
    k1b = chip_smoke.phase_k1_bwd(dev)
    print(json.dumps({"tag": ns.tag, "root": root,
                      "k1_forward_ms": k1["ms"], "k1b_step_ms": k1b["ms"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
