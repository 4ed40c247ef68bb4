"""Model FLOPs of one image through ImageDream and LGM big, the numerator of
``mfu.image``.

Counted as ``torch.utils.flop_counter`` counts them (``counts/flops.py``'s
convention): 2 x multiply-adds of each convolution, dense layer and
attention product, nothing for norms, activations, embeddings' lookups,
resizes and elementwise work. Walks the plain reference's own plan
(``reference/imagedream.py``); the tests hold each stage to the flop
counter over the reference, at a tiny size on the CPU and at the published
widths on the meta device.
"""

from __future__ import annotations

from portbench.counts.flops import conv, lgm_forward
from portbench.reference import imagedream as ref


def dense(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def attend(batch: int, nq: int, nk: int, width: int) -> float:
    """Q.Kᵀ and P.V over ``width`` channels (all heads)."""
    return 4.0 * batch * nq * nk * width


def clip_tower(layers: int, tokens: int, width: int, batch: int = 1) -> float:
    """``layers`` pre-LN blocks: q, k, v, out; attention; the 4x MLP."""
    n = batch * tokens
    per = (4 * dense(n, width, width) + attend(batch, tokens, tokens, width)
           + 2 * dense(n, width, 4 * width))
    return layers * per


def text_encode(cfg: dict) -> float:
    """One prompt through the text tower."""
    return clip_tower(cfg["text_layers"], cfg["max_tokens"],
                      cfg["text_hidden"])


def vision_encode(cfg: dict) -> float:
    """One image through the vision tower to its penultimate layer."""
    side = cfg["image_size"] // cfg["patch_size"]
    h = cfg["vision_hidden"]
    patches = conv(3, h, cfg["patch_size"], side * side)
    return patches + clip_tower(cfg["vision_layers"] - 1, side * side + 1, h)


def _resampler(cfg: dict, n: int, tokens: int) -> float:
    ctx, q = cfg["context_dim"], cfg["ip_dim"]
    inner = ref.RESAMPLER_HEADS * ref.RESAMPLER_HEAD_DIM
    total = dense(n * tokens, cfg["vision_hidden"], ctx)
    per = (dense(n * (tokens + q), ctx, 2 * inner) + dense(n * q, ctx, inner)
           + attend(n, q, tokens + q, inner) + dense(n * q, inner, ctx)
           + 2 * dense(n * q, ctx, 4 * ctx))
    return total + ref.RESAMPLER_DEPTH * per + dense(n * q, ctx, ctx)


def _res(cin: int, cout: int, ted: int, n: int, px: int) -> float:
    total = conv(cin, cout, 3, n * px) + dense(n, ted, cout) \
        + conv(cout, cout, 3, n * px)
    return total + (conv(cin, cout, 1, n * px) if cin != cout else 0.0)


def _st(c: int, cfg: dict, n: int, frames: int, px: int, text: int) -> float:
    tok = n * px
    ctx = cfg["context_dim"]
    total = 2 * dense(tok, c, c)                          # proj_in, proj_out
    total += 4 * dense(tok, c, c)                         # attn1 q, k, v, out
    total += attend(n // frames, frames * px, frames * px, c)
    total += 2 * dense(tok, c, c)                         # attn2 q, out
    total += 2 * dense(n * text, ctx, c) + attend(n, px, text, c)
    if cfg["ip_dim"]:
        q = cfg["ip_dim"]
        total += 2 * dense(n * q, ctx, c) + attend(n, px, q, c)
    return total + dense(tok, c, 8 * c) + dense(tok, 4 * c, c)


def unet_call(cfg: dict, frames: int, side: int, image_tokens: int) -> float:
    """One U-Net call on the CFG pair: 2 x ``frames`` latents of side²."""
    n, mc = 2 * frames, cfg["model_channels"]
    ted = 4 * mc
    total = dense(n, mc, ted) + dense(n, ted, ted) + dense(n, 16, ted) \
        + dense(n, ted, ted)
    if cfg["ip_dim"]:
        total += _resampler(cfg, n, image_tokens)
    ins, mid, outs = ref.unet_plan(cfg)
    res = side

    def block(plan_block):
        nonlocal res
        out = 0.0
        for kind, *a in plan_block:
            px = res * res
            if kind == "conv":
                out += conv(4, mc, 3, n * px)
            elif kind == "res":
                out += _res(a[0], a[1], ted, n, px)
            elif kind == "st":
                out += _st(a[0], cfg, n, frames, px, cfg["max_tokens"])
            elif kind == "down":
                res //= 2
                out += conv(a[0], a[0], 3, n * res * res)
            else:
                res *= 2
                out += conv(a[0], a[0], 3, n * res * res)
        return out

    for b in ins:
        total += block(b)
    px = res * res
    total += 2 * _res(mid, mid, ted, n, px) + _st(mid, cfg, n, frames, px,
                                                   cfg["max_tokens"])
    for b in outs:
        total += block(b)
    return total + conv(mc, 4, 3, n * side * side)


def _vae_res(cin: int, cout: int, n: int, px: int) -> float:
    total = conv(cin, cout, 3, n * px) + conv(cout, cout, 3, n * px)
    return total + (conv(cin, cout, 1, n * px) if cin != cout else 0.0)


def _vae_mid(c: int, n: int, px: int) -> float:
    return (2 * _vae_res(c, c, n, px) + 4 * dense(n * px, c, c)
            + attend(n, px, px, c))


def vae_encode(cfg: dict, side: int, n: int = 1) -> float:
    """``n`` images of side² to their latents' mean."""
    chans = cfg["vae_channels"]
    total = conv(3, chans[0], 3, n * side * side)
    cin, res = chans[0], side
    for i, ch in enumerate(chans):
        for j in range(ref.VAE_LAYERS):
            total += _vae_res(cin if j == 0 else ch, ch, n, res * res)
        if i != len(chans) - 1:
            res //= 2
            total += conv(ch, ch, 3, n * res * res)
        cin = ch
    px = res * res
    total += _vae_mid(chans[-1], n, px)
    return total + conv(chans[-1], 2 * ref.LATENT, 3, n * px) \
        + conv(2 * ref.LATENT, 2 * ref.LATENT, 1, n * px)


def vae_decode(cfg: dict, side: int, n: int) -> float:
    """``n`` latents of side² to images."""
    rev = list(cfg["vae_channels"])[::-1]
    px = side * side
    total = conv(ref.LATENT, ref.LATENT, 1, n * px) \
        + conv(ref.LATENT, rev[0], 3, n * px) + _vae_mid(rev[0], n, px)
    cin, res = rev[0], side
    for i, ch in enumerate(rev):
        for j in range(ref.VAE_LAYERS + 1):
            total += _vae_res(cin if j == 0 else ch, ch, n, res * res)
        if i != len(rev) - 1:
            res *= 2
            total += conv(ch, ch, 3, n * res * res)
        cin = ch
    return total + conv(rev[-1], 3, 3, n * res * res)


def imagedream_image(cfg: dict, lgm: dict, steps: int = 30,
                     frames: int = 4, size: int = 256) -> float:
    """One image: the prompt encoded twice (uncond and cond), the vision
    tower, the VAE's encode of the image, ``steps`` U-Net calls on the
    CFG pair of ``frames`` views and the image's frame, the decode of all
    of them, and LGM big's forward at B 1."""
    f = 2 ** (len(cfg["vae_channels"]) - 1)
    tokens = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    return (2 * text_encode(cfg) + vision_encode(cfg)
            + vae_encode(cfg, size)
            + steps * unet_call(cfg, frames + 1, size // f, tokens)
            + vae_decode(cfg, size // f, frames + 1)
            + lgm_forward(lgm, 1))
