"""Run one cell of the benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets the cell up from the seed (weights on the device, inputs, warm-up of
the cell's own shapes), measures for ``--seconds``, checks what the timed
path produced against the plain references in ``portbench/reference``,
and prints one JSON object as the last line of standard output: the
end-to-end metrics with ``--trace 0``, the per-layer metrics read from a
``torch.profiler`` trace of the window with ``--trace 1``. The numbers the
check compared are the last lines of standard error and the last key of
the result. Exits non-zero, printing no result, without a CUDA device,
with fewer devices than the cell asks for, or when a module of JAX or of
the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    wl = harness.load_json(harness.HERE / "workloads"
                           / f"{args.workload}.json")
    chips = wl["chips"]
    # A cell may fix the host threads of PyTorch's and the BLAS's CPU work
    # (before torch is imported); without ``host_threads`` they stay at
    # PyTorch's default.
    threads = wl["params"].get("host_threads")
    if threads:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(threads)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if threads:
        torch.set_num_threads(threads)
    torch.cuda.set_device(0)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: the run loaded {banned}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
