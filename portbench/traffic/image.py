"""Traffic ``image``: one image to 3D, one image after another, one client.

Each image is what ``infer --image`` runs, without ``rembg`` and the file
output: ``infer.image_to_views`` with the configuration's ImageDream
pipeline (recentre, the conditioning, 30 DDIM steps on the CFG pair at
guidance 5.0, elevation 0, the decode, views [1, 2, 3, 0]), then
``infer.forward_gaussians`` with LGM big and ``infer.render_orbit_video``
of its Gaussians (180 frames, chunks of 30, uint8 on the host), as the
object cell calls them. The inputs are a cycle of ``images`` seeded
objects, each rendered by the plain renderer at ``image_size``² with its
alpha, in OpenCV's BGRA order; set-up also runs one whole image, which
warms up every shape of the window. The weights are drawn on the card
from the seed and handed to the program through its own loaders; the
harness drops its copy before the first image.

The end-to-end metric is ``object_peak_gib``, the device memory the
program holds at its peak over the warm image and the window. An image's
seconds are read per layer (``object_time_s.image``), as the object
cell's are.

The check runs the plain references (``reference/imagedream.py``, the LGM
and the renderer) on the program's own inputs at each stage of a sample
of the window's images drawn from the seed, so that no chaotic
trajectory is compared:

- ``cond_gap``: the worst relative gap of the program's text context
  (both CFG branches), CLIP image features and image latent, as its
  U-Net received them, against the plain towers' from the same image;
- ``eps_gap``: at one step drawn from the seed, the program's ε of each
  CFG branch (a forward hook on ``pipe.unet``) against the plain U-Net's
  on the same latents and conditioning, the worse branch's relative
  Frobenius gap;
- ``view_gap``: the program's four views against the plain decoder and
  host steps applied to the program's final latents, the worst view's
  RMS in 8-bit levels;
- ``trajectory_rms``: the program's views against the whole plain path
  (conditioning, 30 guided steps, decoder, host steps) from the same
  image and the program's own initial noise, the worst view's RMS in
  8-bit levels. Compared since its readings separate the program from
  the control (PERF.md §6): each step's rounding stays well under
  the image's range over 30 steps at these weights;
- ``gauss_gap``, ``frame_rms``: the object cell's, on the program's
  views and Gaussians.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts import attention
from portbench.counts.imagedream import imagedream_image
from portbench.harness import Window
from portbench.reference import camera, scenes, weights
from portbench.reference import imagedream as ref
from portbench.reference import lgm as ref_lgm
from portbench.reference.precision import PRECISIONS
from portbench.reference.render import render_view
from portbench.timeline import WINDOW
from portbench.traffic import object as object_mix
from portbench.traffic.train import make_options

TOKENIZER = Path(__file__).resolve().parents[1] / "tokenizer"
# The pipeline's image size, which ``image_to_views`` asks for.
SIZE = 256
# The CLIP towers are stated in f32 and the U-Net and VAE in bf16: the
# control rounds each a step below.
CONTROL = {"fp32": (ref.full, ref.full), "control": (ref.bf16, ref.fp8)}


def pipeline_fields(config: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["pipeline"].items()}


@torch.no_grad()
def diffusion_weights(ctx, device) -> dict:
    """{component: {name: tensor}} under the published layout's names: one
    ``torch.randn`` of every weight on ``device`` from the seed's own
    stream, scaled by kind (``assumed.diffusion_init``)."""
    cfg = ctx.config["pipeline"]
    rules = ctx.config["assumed"].get("diffusion_init", {})
    shapes = ref.param_shapes(cfg)
    total = sum(int(torch.Size(s).numel())
                for comp in shapes.values() for s in comp.values())
    flat = torch.randn(total, generator=weights.generator(ctx.seed + 2,
                                                          device),
                       device=device)
    out, off = {}, 0
    for comp, named in shapes.items():
        norms = set(ref.norm_scales(named))
        out[comp] = {}
        for name, shape in named.items():
            n = int(torch.Size(shape).numel())
            w = flat[off:off + n].view(shape)
            off += n
            if f"{comp}.{name}" in rules:
                w.mul_(rules[f"{comp}.{name}"]["std"])
            elif name in norms:
                w.mul_(0.1).add_(1.0)
            elif len(shape) >= 2:
                w.mul_((n // shape[0]) ** -0.5)
            else:
                w.mul_(0.02)
            out[comp][name] = w
    return out


def prompt_ids(max_tokens: int, device) -> torch.Tensor:
    """The empty prompt's ids [1, L] from the benchmark's vocabulary: bos,
    eos, then eos as the pad."""
    vocab = json.loads((TOKENIZER / "vocab.json").read_text())
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    return torch.tensor([[bos] + [eos] * (max_tokens - 1)], device=device)


def bgra_image(rng: np.random.Generator, opts: dict, n_gaussians: int,
               size: int, dup: int, device) -> np.ndarray:
    """A seeded object seen from elevation 0 at a seeded azimuth: float
    [size, size, 4] BGRA in [0, 1], the colour unpremultiplied by the
    alpha (zero where nothing was drawn)."""
    scene = torch.as_tensor(scenes.sample_scene(rng, n_gaussians),
                            device=device)
    pose = camera.orbit_camera(0.0, rng.uniform(0.0, 360.0),
                               opts["cam_radius"])
    view = torch.as_tensor(camera.cam_view(pose[None])[0], device=device)
    rgb, alpha = render_view(scene, view, size, scenes.tan_half_fov(opts),
                             torch.zeros(3, device=device), dup)
    a = alpha.clamp(0.0, 1.0)[..., None]
    rgb = torch.where(a > 0, (rgb / a.clamp(min=1e-12)).clamp(0.0, 1.0),
                      torch.zeros_like(rgb))
    return torch.cat([rgb[..., [2, 1, 0]], a], -1).cpu().numpy()


def gap(a, b) -> float:
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float(torch.linalg.vector_norm(a - b.to(a.device))
                 / torch.linalg.vector_norm(b))


def rms8(a, b) -> float:
    """The worst view's RMS gap in 8-bit levels of views [V, S, S, 3]."""
    d = 255.0 * (torch.as_tensor(a).double().cpu()
                 - torch.as_tensor(b).double().cpu())
    return float(d.pow(2).mean(dim=(1, 2, 3)).sqrt().max())


def compare(made: list, want: list) -> dict:
    """The check's numbers over the sampled images: ``made`` and ``want``
    hold each image's stages (``Cell.stages``)."""
    out = {"cond_gap": 0.0, "eps_gap": 0.0, "view_gap": 0.0,
           "trajectory_rms": 0.0, "gauss_gap": 0.0, "frame_rms": 0.0}
    for m, w in zip(made, want):
        cond = max(gap(m[k], w[k]) for k in ("text", "features", "latent"))
        F = m["eps"].shape[0] // 2
        eps = max(gap(m["eps"][s], w["eps"][s])
                  for s in (slice(0, F), slice(F, None)))
        view = rms8(m["views"], w["views"])
        path = rms8(m["trajectory"], w["trajectory"])
        obj = object_mix.compare([(m["gaussians"], m["frames"])],
                                 [w["gaussians"]], [w["frames"]])
        for k, v in (("cond_gap", cond), ("eps_gap", eps),
                     ("view_gap", view), ("trajectory_rms", path),
                     ("gauss_gap", obj["gauss_gap"]),
                     ("frame_rms", obj["frame_rms"])):
            out[k] = max(out[k], float(v) if np.isfinite(v) else np.inf)
    return out


class Cell(object_mix.Cell):
    """The object cell's orbit and its references, behind ImageDream."""

    def setup(self):
        from lgm_tpu_torch import infer
        from lgm_tpu_torch.diffusion.pipeline import (MVDreamPipeline,
                                                      PipelineConfig)
        from lgm_tpu_torch.diffusion.tokenizer import CLIPTokenizer

        ctx, p = self.ctx, self.ctx.traffic
        self.infer = infer
        self.opt = make_options(ctx.options)
        self.pcfg = ctx.config["pipeline"]
        self.sampling = ctx.config["sampling"]
        config = PipelineConfig(**pipeline_fields(ctx.config))
        self.pipe = MVDreamPipeline(
            config, ctx.device,
            tokenizer=CLIPTokenizer(str(TOKENIZER), config.max_tokens))
        self.pipe.load_state_dicts(diffusion_weights(ctx, self.dev))
        self.model = infer.load_model(self.opt, device=ctx.device)
        self.model.load_state_dict(object_mix.lgm_weights(ctx, self.dev))
        self.w = self.dw = None
        rng = np.random.default_rng(ctx.seed)
        self.images = [bgra_image(rng, ctx.options, p["scene_gaussians"],
                                  p["image_size"], p["dup"], self.dev)
                       for _ in range(p["images"])]
        # The step whose ε the check compares, and the program's inputs
        # and outputs it reads, caught during each image.
        self.step = int(np.random.default_rng((ctx.seed, 2)).integers(
            self.sampling["steps"]))
        self._calls, self._caught = 0, {}
        self._hook = self.pipe.unet.register_forward_hook(self._unet_hook,
                                                          with_kwargs=True)
        decode = self.pipe.decode

        def caught_decode(latents):
            self._caught["final"] = latents.detach().clone()
            return decode(latents)
        self.pipe.decode = caught_decode
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.done = []
        self._image(0)
        self.done = []

    def _unet_hook(self, module, args, kwargs, out):
        if self._calls == self.step:
            x, _, context, frames = args
            self._caught.update(
                lat=x[:frames].detach().clone(),
                text=context[::frames].detach().clone(),
                features=kwargs["ip"][frames:frames + 1].detach().clone(),
                latent=kwargs["ip_img"][1:].detach().clone(),
                eps=out.detach().clone())
        self._calls += 1

    def _image(self, k: int):
        self._calls, self._caught = 0, {}
        s = self.sampling
        t0 = time.perf_counter()
        with record_function("portbench.views"):
            views = self.infer.image_to_views(
                self.pipe, self.images[k % len(self.images)], self.opt,
                elevation=s["elevation"])
        caught = {name: v.cpu() for name, v in self._caught.items()}
        self._caught = {}
        t1 = time.perf_counter()
        with record_function("portbench.forward"):
            g = self.infer.forward_gaussians(self.model, views)
        t2 = time.perf_counter()
        with record_function("portbench.orbit"):
            frames = self.infer.render_orbit_video(
                g[0], self.opt, n_frames=self.ctx.traffic["frames"],
                chunk=self.ctx.traffic["chunk"], device=self.ctx.device,
                n_devices=self.ctx.chips)
        t3 = time.perf_counter()
        caught.update(views=views, gaussians=g[0], frames=frames)
        self.done.append((k, caught))
        return t1 - t0, t2 - t1, t3 - t2

    def window(self, seconds: float) -> Window:
        spans = {"views": [], "forward": [], "orbit": []}
        with record_function(WINDOW):
            t0 = time.perf_counter()
            k = 0
            while True:
                for name, v in zip(spans, self._image(k)):
                    spans[name].append(v)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        failed = sum(not (np.isfinite(c["views"]).all()
                          and np.isfinite(c["gaussians"]).all())
                     for _, c in self.done)
        return Window(units=k, attempted=k, failed=int(failed),
                      seconds=t1 - t0, spans=spans)

    def reading(self, win: Window) -> dict:
        opts, steps = self.ctx.options, self.sampling["steps"]
        side = SIZE // 2 ** (len(self.pcfg["vae_channels"]) - 1)
        heads = self.pcfg["model_channels"] // self.pcfg["num_head_channels"]
        # The U-Net's level-0 joint self-attention over the 5 frames of
        # each CFG branch, 5 sites a call (K1), and LGM's sites.
        level0 = [(2 * heads, 5 * side * side,
                   self.pcfg["num_head_channels"])] * 5
        return {"units": win.units, "seconds": win.seconds,
                "spans": win.spans,
                "flops_per_unit": imagedream_image(self.pcfg, opts, steps),
                "k1_calls": level0 * steps + attention.lgm_sites(opts, 1),
                "k1b_calls": []}

    def release(self):
        self._hook.remove()
        del self.pipe.decode          # the wrapper holds the pipeline
        del self.pipe
        super().release()

    def ref_diffusion(self) -> dict:
        """The diffusion weights the program was given, made again."""
        if self.dw is None:
            self.dw = diffusion_weights(self.ctx, self.dev)
        return self.dw

    def sample(self) -> list:
        rng = np.random.default_rng((self.ctx.seed, 1))
        n = min(self.ctx.traffic["check_images"], len(self.done))
        return sorted(rng.choice(len(self.done), n, replace=False).tolist())

    def made(self, i: int) -> dict:
        """The program's stages of the window's image ``i``."""
        c = self.done[i][1]
        return dict(c, trajectory=c["views"])

    @torch.no_grad()
    def stages(self, i: int, precision: str = "fp32") -> dict:
        """The plain references' stages on the program's own inputs of the
        window's image ``i``: the conditioning from the image, ε from the
        program's latents and conditioning at the drawn step, the views
        from its final latents, the Gaussians from its views and the
        frames from its Gaussians; and the whole plain path from the image
        and the program's own initial noise (``torch.randn`` of a
        generator seeded 0 on the device, as ``MVDreamPipeline.__call__``
        draws it)."""
        ref.exact()
        q_clip, q = CONTROL[precision]
        k, c = self.done[i]
        dev, cfg, w = self.dev, self.pcfg, self.ref_diffusion()
        ids = prompt_ids(cfg["max_tokens"], dev)
        bgra = torch.as_tensor(self.images[k % len(self.images)])
        out = ref.conditions(w, bgra, ids, cfg, SIZE, q_clip, q)
        frames = c["lat"].shape[0] - 1
        kw = ref.unet_inputs(c["text"].to(dev), c["features"].to(dev),
                             c["latent"].to(dev), frames,
                             self.sampling["elevation"])
        t = ref.ddim_schedule(self.sampling["steps"])[self.step][0]
        x = c["lat"].to(dev).repeat(2, 1, 1, 1)
        out["eps"] = ref.unet(w["unet"], x, torch.full(
            (x.shape[0],), float(t), device=dev), kw["context"], frames + 1,
            kw["camera"], cfg, kw["ip"], kw["ip_img"], q)
        out["views"] = ref.views_of(ref.vae_decode(
            w["vae"], c["final"].to(dev), cfg, q), self.opt.input_size)
        noise = torch.randn(tuple(c["final"].shape), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
        s = self.sampling
        out["trajectory"] = ref.image_to_views(
            w, bgra, ids, noise, cfg, self.opt.input_size, s["steps"],
            s["guidance"], s["elevation"], q_clip, q)
        opts = self.ctx.options
        poses = camera.orbit_views(opts["num_input_views"],
                                   opts["cam_radius"])
        x = scenes.network_input(torch.as_tensor(c["views"], device=dev),
                                 poses, opts)[None]
        out["gaussians"] = ref_lgm.gaussians(
            self.ref_weights(), x, opts, PRECISIONS[precision].q)[0]
        out["frames"] = self.frames([c["gaussians"]], precision)[0]
        return out

    def check(self) -> dict:
        picks = self.sample()
        return compare([self.made(i) for i in picks],
                       [self.stages(i) for i in picks])

    def control_check(self) -> dict:
        """``check`` with the control, the references a step below each
        stated precision, in the program's place."""
        picks = self.sample()
        return compare([self.stages(i, "control") for i in picks],
                       [self.stages(i) for i in picks])
