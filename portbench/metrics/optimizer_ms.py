"""``optimizer_ms``: host milliseconds a step inside the program's range
``optimizer`` (``record_function``), from the traced window."""


def read(tl, r):
    s, n = tl.span_s("optimizer")
    if not n or not r["units"]:
        return None
    return 1e3 * s / r["units"]
