"""``denoise_launches``: the host's kernel launch calls a denoising step:
those in the traced window (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel``, ``cuLaunchKernelEx``) that start inside the program's
range ``diffusion.denoise``, over the steps the program counted there
(``diffusion.steps``, ``lgm_tpu_torch.trace.counters()`` read in this
process after the window). What a CUDA graph of the step would replay
as one launch. Not read (None) where the program keeps no such range or
counted no step.

The loop runs on the calling thread and nothing else launches while it
runs, so a launch is placed by its start alone (``render_launches``).
"""

from bisect import bisect_right

from portbench.timeline import union

LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx"}


def read(tl, r):
    try:
        from lgm_tpu_torch import trace
    except ImportError:
        return None
    steps = trace.counters().get("diffusion.steps", 0)
    lo, hi = tl.window
    inside = union([(s, e) for s, e, name in tl.spans
                    if name == "diffusion.denoise"], lo, hi)
    if not inside or not steps:
        return None
    starts = [s for s, _ in inside]
    n = 0
    for s, _, name in tl.ops:
        if name in LAUNCHES:
            i = bisect_right(starts, s) - 1
            n += i >= 0 and s < inside[i][1]
    return n / steps
