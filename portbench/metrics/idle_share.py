"""``idle_share``: the share of the traced window in which the device ran
nothing: 1 - (the union of its kernel, memcpy and memset intervals) / the
window, in percent."""


def read(tl, r):
    if tl.window_s <= 0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
