"""``lpips_bwd_ms``: host milliseconds a step inside the program's range
``lpips.backward``, LPIPS's backward (its checkpointed chunks
recomputed, from the loss's gradient to the prediction's), from the
traced window."""


def read(tl, r):
    s, n = tl.span_s("lpips.backward")
    if not n or not r["units"]:
        return None
    return 1e3 * s / r["units"]
