"""``denoise_ms``: host milliseconds an image inside the program's range
``diffusion.denoise``, the DDIM loop of ``MVDreamPipeline.denoise`` (its
U-Net calls on the CFG pair and the updates, launched without a
synchronize), from the traced window."""


def read(tl, r):
    s, n = tl.span_s("diffusion.denoise")
    if not n or not r["units"]:
        return None
    return 1e3 * s / r["units"]
