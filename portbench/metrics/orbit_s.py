"""``orbit_s``: host seconds of ``infer.render_orbit_video`` an object, the
benchmark's own span around the call (it returns frames on the host)."""


def read(tl, r):
    spans = r["spans"].get("orbit")
    return sum(spans) / len(spans) if spans else None
