"""``mfu``: the model FLOPs the window completed (``counts/flops``, from the
configuration's widths, a unit of work times the units) over the traced
window times the card's bf16 dense peak, in percent."""

from portbench.counts.peaks import BF16_TENSOR_FLOPS


def read(tl, r):
    if not r["units"] or tl.window_s <= 0:
        return None
    return 100.0 * r["flops_per_unit"] * r["units"] / (
        tl.window_s * BF16_TENSOR_FLOPS)
