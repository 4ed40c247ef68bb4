"""Model FLOPs from a configuration's widths, the numerator of ``mfu``.

Counted as ``torch.utils.flop_counter`` counts them: 2 x multiply-adds of
each convolution, dense layer and attention product, nothing for norms,
activations and elementwise work. The tests hold these sums to the flop
counter over the plain references on the meta device.
"""

from __future__ import annotations

from portbench.reference import lgm as ref_lgm
from portbench.reference.lpips import STAGES


def conv(cin: int, cout: int, k: int, pixels: int) -> float:
    return 2.0 * cin * cout * k * k * pixels


def lgm_forward(cfg: dict, batch: int) -> float:
    """One LGM forward over ``batch`` scenes of V input views."""
    V = cfg["num_input_views"]
    images = batch * V
    res = cfg["input_size"]
    total = conv(9, cfg["down_channels"][0], 3, images * res * res)
    for entry in ref_lgm.blocks(cfg):
        kind = entry[0]
        px = images * res * res
        if kind in ("res", "res_skip"):
            cin, cout = entry[2], entry[3]
            total += conv(cin, cout, 3, px) + conv(cout, cout, 3, px)
            if cin != cout:
                total += conv(cin, cout, 1, px)
        elif kind == "attn":
            c, S = entry[2], V * res * res
            # qkv and proj; Q.Kᵀ and P.V over the scene's S tokens.
            total += 2.0 * batch * S * c * 4 * c + 4.0 * batch * S * S * c
        elif kind == "down":
            res //= 2
            total += conv(entry[2], entry[2], 3, images * res * res)
        elif kind == "up":
            res *= 2
            total += conv(entry[2], entry[2], 3, images * res * res)
    c = cfg["up_channels"][-1]
    total += conv(c, 14, 3, images * res * res) + conv(14, 14, 1,
                                                       images * res * res)
    return total


def vgg_forward(size: int = 256) -> float:
    """One image through LPIPS's VGG-16 tower at ``size``²."""
    total, cin, res = 0.0, 3, size
    for si, (n, ch) in enumerate(STAGES):
        for _ in range(n):
            total += conv(cin, ch, 3, res * res)
            cin = ch
        res //= 2
    return total


def lgm_train_step(cfg: dict, batch: int) -> float:
    """A training step's model FLOPs: the U-Net forward and its backward
    (twice the forward; the recompute under remat not counted), LPIPS's
    tower over both images of every supervision view and its backward
    through the prediction (once the forward: no weight gradient)."""
    views = batch * cfg["num_views"]
    lpips = (3.0 * vgg_forward(min(cfg["output_size"], 256)) * views
             if cfg["lambda_lpips"] > 0 else 0.0)
    return 3.0 * lgm_forward(cfg, batch) + lpips
