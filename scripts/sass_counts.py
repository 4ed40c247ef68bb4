#!/usr/bin/env python3
"""Count the warp shuffles and shared-memory loads of every kernel of the
port, from ``cuobjdump -sass`` of the libraries ``nvcc`` builds.

Run from the root of a checkout on a host with the CUDA toolkit:

    python3 scripts/sass_counts.py [--root DIR] [--out FILE]

``--root`` takes the kernel sources of another checkout (an unpacked
``git archive`` of an earlier commit, say) and builds them with this
checkout's flags into ``build/sass/``, so that two versions are counted
by one script. Prints one JSON object, ``{library: {kernel: {"SHFL": n,
"LDS": n, "loop": n, "loop_SHFL": n, "loop_LDS": n}}}`` (static
instruction counts: a loop body counts once; ``loop*`` are the kernel's
longest loop), and with ``--out`` also writes it to FILE.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lgm_tpu_torch.ops import _build  # noqa: E402


def build_other(root: Path) -> dict:
    """Every ``lgm_tpu_torch/**/csrc/*.cu`` under ``root``, built with this
    checkout's nvcc flags into ``build/sass/<name>.so``."""
    out_dir = Path(ROOT) / "build" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for src in sorted(root.glob("lgm_tpu_torch/**/csrc/*.cu")):
        so = out_dir / f"{src.stem}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True, capture_output=True)
        libs[src.stem] = so
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=None,
                        help="checkout whose kernel sources to count")
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the JSON object to this file")
    args = parser.parse_args()
    libs = build_other(args.root) if args.root else _build.build()
    counts = {name: _build.sass_counts(so) for name, so in libs.items()}
    text = json.dumps(counts, sort_keys=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
