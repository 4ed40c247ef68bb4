"""``attn_roofline``: the attention kernels' share of their roofline over
the traced window: the least time their calls need (``counts/attention``,
by shape) over the device time they took, in percent.

K1 is ``mha_fwd_wgmma_kernel<D, ...>``; K1ᵇ is a dq and a dK/dV kernel a
call (``mha_bwd_dq_wgmma_kernel<D, ...>``, ``mha_bwd_dkv_wgmma_kernel``).
The trace gives each launch's head dim D but not its lengths; the cell
says which calls a unit of its work makes (``k1_calls``, ``k1b_calls``:
(BH, S, D) each), and each launch of head dim D is given the mean bound of
the unit's calls of that D. A trace whose launches of some kind and D are
not the window's units times the unit's calls is not read.
"""

import re
from collections import Counter

from portbench.counts.attention import k1_bound_s, k1b_bound_s

KERNEL = re.compile(r"mha_(fwd|bwd_dq|bwd_dkv)_wgmma_kernel<(\d+)")


def _by_dim(calls, bound):
    total, count = Counter(), Counter()
    for BH, S, D in calls:
        total[D] += bound(BH, S, S, D)
        count[D] += 1
    return total, count


def read(tl, r):
    lo, hi = tl.window
    launches, seconds = Counter(), 0.0
    for s, e, name in tl.device:
        m = KERNEL.search(name)
        if m and lo <= s < hi:
            launches[(m.group(1), int(m.group(2)))] += 1
            seconds += (e - s) * 1e-9
    if not launches or seconds <= 0:
        return None
    need = 0.0
    for kind, calls, bound in (("fwd", r["k1_calls"], k1_bound_s),
                               ("bwd_dq", r["k1b_calls"], k1b_bound_s)):
        total, count = _by_dim(calls, bound)
        for D in {d for k, d in launches if k == kind} | set(count):
            if launches[(kind, D)] != r["units"] * count[D]:
                return None
            need += r["units"] * total[D]
    return 100.0 * need / seconds
