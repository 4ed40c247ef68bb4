"""``composite_roofline``: the compositors' share of their roofline over
the traced window, in percent: the least time of the work K2 and K2ᵇ
counted themselves (``counts/composite``) over the device time of
``composite_fwd_kernel`` and ``composite_bwd_kernel`` in the window.

The counts are the program's (``lgm_tpu_torch.trace.counters()``, read in
this process after the window): the profiler ran only around the window,
and each kernel adds its pairs and bytes only then. Each kernel's bound is
that of its summed counts, which is at most the sum of its launches'
bounds. Not read (None) where the program keeps no counters, or where the
launches it counted are not the kernels the trace found.
"""

from portbench.counts.composite import composite_bound_s

KERNELS = ("composite_fwd", "composite_bwd")


def read(tl, r):
    try:
        from lgm_tpu_torch import trace
    except ImportError:
        return None
    counted = trace.counters()
    need, seconds = 0.0, 0.0
    for kernel in KERNELS:
        s, n = tl.kernel_s(lambda name: f"{kernel}_kernel" in name)
        if n != counted.get(f"{kernel}.launches", 0):
            return None
        if n:
            need += composite_bound_s(counted[f"{kernel}.pairs"],
                                      counted[f"{kernel}.bytes"])
            seconds += s
    if seconds <= 0:
        return None
    return 100.0 * need / seconds
