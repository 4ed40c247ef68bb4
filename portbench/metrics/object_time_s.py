"""``object_time_s``: host seconds an object, the traced window's seconds
over the whole objects it completed (forward and orbit, frames on the
host). The profiler slows the host chain, so it reads above what an
untraced run would."""


def read(tl, r):
    units = r.get("units")
    return r["seconds"] / units if units and "seconds" in r else None
