"""The least time of the compositors K2 (forward) and K2ᵇ (backward) from
the work they count themselves (``lgm_tpu_torch/trace.py``): that work
depends on the data, since a tile's chunk loop ends at its count or where
no pixel's transmittance is left, and only the kernels see where.

Copies of the bring-up's ``chip_smoke.py::k2_bound`` / ``k2b_bound``
without their ``used`` terms (the (pixel, slot) pairs that pass the alpha
test), which the kernels do not count: each visited pair costs one exp on
the SFU and ``K2_OPS_TEST`` f32 operations up to its alpha test; the bytes
are what the kernel and its wrapper counted (each byte read or written
once). The bound stands while every visited pair takes its exp and its
test; a kernel that culled pairs without evaluating them would need
another count.
"""

from __future__ import annotations

from portbench.counts.peaks import F32_FLOPS, SFU_EXP_PER_S, bound_s

# f32 operations a visited (pixel, slot) pair takes up to the alpha test:
# dx, dy, the quadratic, op * e (chip_smoke.py's K2_OPS_TEST).
K2_OPS_TEST = 14


def composite_bound_s(pairs: int, bytes_moved: int) -> float:
    return bound_s({"exp": pairs / SFU_EXP_PER_S,
                    "f32": K2_OPS_TEST * pairs / F32_FLOPS}, bytes_moved)
