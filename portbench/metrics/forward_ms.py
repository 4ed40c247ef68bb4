"""``forward_ms``: host milliseconds of ``infer.forward_gaussians`` an
object, the benchmark's own span around the call (it returns the
Gaussians on the host)."""


def read(tl, r):
    spans = r["spans"].get("forward")
    return 1e3 * sum(spans) / len(spans) if spans else None
