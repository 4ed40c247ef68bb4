"""``render_bwd_ms``: host milliseconds a step inside the program's range
``render.backward``, the renderer's backward (autograd's thread: from
the gradient reaching its outputs to the Gaussians' gradient), from the
traced window."""


def read(tl, r):
    s, n = tl.span_s("render.backward")
    if not n or not r["units"]:
        return None
    return 1e3 * s / r["units"]
