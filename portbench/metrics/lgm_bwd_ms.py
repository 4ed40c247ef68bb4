"""``lgm_bwd_ms``: host milliseconds a step inside the program's range
``lgm.backward``, the LGM's backward (from the Gaussians' gradient to
the end of the backward pass: the U-Net's recompute and backward), from
the traced window."""


def read(tl, r):
    s, n = tl.span_s("lgm.backward")
    if not n or not r["units"]:
        return None
    return 1e3 * s / r["units"]
