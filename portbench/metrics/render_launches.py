"""``render_launches``: the renderer's kernel launches a unit of work: the
host's launch calls (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel``, ``cuLaunchKernelEx``) in the traced window that start
inside a range ``render`` or ``render.backward`` of the program.

The timeline keeps no thread ids, so a launch is placed by its start
alone. That holds here: the renderer's backward runs on autograd's thread
while the thread that called ``backward()`` waits in it, and the forward
runs on the calling thread while autograd's thread is idle, so no other
thread launches inside these ranges.
"""

from bisect import bisect_right

from portbench.timeline import union

LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx"}
RANGES = {"render", "render.backward"}


def read(tl, r):
    lo, hi = tl.window
    inside = union([(s, e) for s, e, name in tl.spans if name in RANGES],
                   lo, hi)
    if not inside or not r["units"]:
        return None
    starts = [s for s, _ in inside]
    n = 0
    for s, _, name in tl.ops:
        if name in LAUNCHES:
            i = bisect_right(starts, s) - 1
            n += i >= 0 and s < inside[i][1]
    return n / r["units"]
