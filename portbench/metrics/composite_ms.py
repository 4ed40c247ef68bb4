"""``composite_ms``: device milliseconds of the compositors a unit of work
(a step or an object): K2 (``composite_fwd_kernel``) and K2ᵇ
(``composite_bwd_kernel``), by kernel name."""


def read(tl, r):
    s, n = tl.kernel_s(lambda name: "composite_fwd_kernel" in name
                       or "composite_bwd_kernel" in name)
    if not n or not r["units"]:
        return None
    return 1e3 * s / r["units"]
