"""Traffic ``object``: four views to 3D, one object after another, one
client.

Each object is the two device calls of the program's ``infer.process``:
``infer.forward_gaussians`` on four 256² views (azimuth 0/90/180/270,
elevation 0) and ``infer.render_orbit_video`` of its Gaussians (180 frames
at the output size, chunks of 30, uint8 on the host). The ``.ply`` and
mp4 writes are host file output and stay out of the window. The inputs
are a cycle of ``objects`` view sets of distinct seeded objects, rendered
by the plain renderer in set-up; set-up also runs one whole object, which
warms up every shape of the window.

The end-to-end metric is ``object_peak_gib``, the device memory that the
program holds at its peak over the warm object and the window. The
seconds an object are read per layer (``object_time_s``): on the hosts of
one-card machines they spread 14-19% from run to run.

The check, in two stages: a sample of the window's objects drawn from the
seed goes through the plain LGM in f32, and the program's Gaussians are
compared with its (relative gap, Frobenius); the program's frames are
compared with the plain renderer's frames of the program's own Gaussians
(the worst frame's RMS gap, in 8-bit levels). The renderer is judged on
the Gaussians it was given because a frame is not a smooth function of
them: bf16's rounding of the positions (a few pixels at 512²) reorders
the front splats, and frames of the program's and the reference's
Gaussians differ by 17-61 levels RMS (an H100, 12 seeds).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import Window
from portbench.reference import camera, scenes, weights
from portbench.reference import lgm as ref_lgm
from portbench.reference.precision import PRECISIONS, f32_only
from portbench.reference.render import render_view, to_uint8
from portbench.timeline import WINDOW
from portbench.traffic.train import make_options


def lgm_weights(ctx, device):
    return weights.make(ref_lgm.param_shapes(ctx.options), ctx.seed, device,
                        ctx.config["assumed"].get("init", {}))


def compare(made: list, ref_gaussians: list, judged: list) -> dict:
    """``gauss_gap``: the largest ||g - g_ref|| / ||g_ref|| of the sampled
    objects' Gaussians against the plain LGM's from the same views;
    ``frame_rms``: the largest RMS gap of one frame, in 8-bit levels,
    against the plain renderer's frames of the same Gaussians (``judged``).
    ``made`` holds (Gaussians, frames) of each object."""
    gauss, frame = 0.0, 0.0
    for (g, frames), g_ref, f_ref in zip(made, ref_gaussians, judged):
        g, g_ref = (torch.as_tensor(x).double().cpu().numpy()
                    for x in (g, g_ref))
        gauss = max(gauss, np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref))
        d = frames.astype(np.float64) - f_ref.astype(np.float64)
        frame = max(frame, float(np.sqrt((d * d).mean(axis=(1, 2, 3))).max()))
    return {"gauss_gap": float(gauss), "frame_rms": frame}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = torch.device(ctx.device)
        self.cuda = self.dev.type == "cuda"

    def setup(self):
        from lgm_tpu_torch import infer

        ctx, p = self.ctx, self.ctx.traffic
        self.infer = infer
        self.opt = make_options(ctx.options)
        self.model = infer.load_model(self.opt, device=ctx.device)
        self.model.load_state_dict(lgm_weights(ctx, self.dev))
        # The references make the weights again after the window, so that
        # the peak of the warm object and the window is the program's.
        self.w = None
        rng = np.random.default_rng(ctx.seed)
        self.views = [scenes.object_views(rng, ctx.options,
                                          p["scene_gaussians"], self.dev)
                      for _ in range(p["objects"])]
        if self.cuda:
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.done = []
        self._object(0)
        self.done = []

    def _object(self, k: int):
        t0 = time.perf_counter()
        with record_function("portbench.forward"):
            g = self.infer.forward_gaussians(
                self.model, self.views[k % len(self.views)])
        t1 = time.perf_counter()
        with record_function("portbench.orbit"):
            frames = self.infer.render_orbit_video(
                g[0], self.opt, n_frames=self.ctx.traffic["frames"],
                chunk=self.ctx.traffic["chunk"], device=self.ctx.device,
                n_devices=self.ctx.chips)
        t2 = time.perf_counter()
        self.done.append((k, g[0], frames))
        return t1 - t0, t2 - t1

    def window(self, seconds: float) -> Window:
        spans = {"forward": [], "orbit": []}
        with record_function(WINDOW):
            t0 = time.perf_counter()
            k = 0
            while True:
                fwd, orbit = self._object(k)
                spans["forward"].append(fwd)
                spans["orbit"].append(orbit)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        failed = sum(not np.isfinite(g).all() for _, g, _ in self.done)
        return Window(units=k, attempted=k, failed=int(failed),
                      seconds=t1 - t0, spans=spans)

    def end_to_end(self, win: Window) -> dict:
        if not self.cuda:
            return {}
        return {"object_peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    def reading(self, win: Window) -> dict:
        return {"units": win.units, "seconds": win.seconds,
                "spans": win.spans}

    def release(self):
        del self.model
        self.infer = None
        if self.cuda:
            torch.cuda.empty_cache()

    def ref_weights(self) -> dict:
        """The weights the program was given, made again from the seed."""
        if self.w is None:
            self.w = lgm_weights(self.ctx, self.dev)
        return self.w

    def sample(self) -> list:
        """The window's objects that the check compares, drawn from the
        seed."""
        rng = np.random.default_rng((self.ctx.seed, 1))
        n = min(self.ctx.traffic["check_objects"], len(self.done))
        return sorted(rng.choice(len(self.done), n, replace=False).tolist())

    @torch.no_grad()
    def gaussians(self, picks: list, precision: str = "fp32") -> list:
        """The plain LGM's Gaussians [N, 14] from the views of the picked
        objects."""
        f32_only()
        opts, out = self.ctx.options, []
        poses = camera.orbit_views(opts["num_input_views"],
                                   opts["cam_radius"])
        for i in picks:
            k = self.done[i][0]
            images = torch.as_tensor(self.views[k % len(self.views)],
                                     device=self.dev)
            x = scenes.network_input(images, poses, opts)[None]
            out.append(ref_lgm.gaussians(self.ref_weights(), x, opts,
                                         PRECISIONS[precision].q)[0])
        return out

    @torch.no_grad()
    def frames(self, gaussians: list, precision: str = "fp32") -> list:
        """The plain renderer's orbit (uint8 [F, S, S, 3]) of each
        Gaussians [N, 14]."""
        f32_only()
        opts, p = self.ctx.options, self.ctx.traffic
        cams = torch.as_tensor(camera.cam_view(camera.orbit_views(
            p["frames"], opts["cam_radius"])), device=self.dev)
        white = torch.ones(3, device=self.dev)
        tan = scenes.tan_half_fov(opts)
        return [torch.stack([to_uint8(render_view(
            torch.as_tensor(g, device=self.dev), c, opts["output_size"], tan,
            white, p["dup"], dtype=PRECISIONS[precision].render)[0])
            for c in cams]).cpu().numpy() for g in gaussians]

    def control(self, picks: list) -> tuple:
        """The reference a step below each stated precision in the
        program's place: (made, reference Gaussians, judged frames) for
        ``compare``."""
        g = self.gaussians(picks, "control")
        made = list(zip([x.cpu().numpy() for x in g],
                        self.frames(g, "control")))
        return made, self.gaussians(picks), self.frames(g)

    def control_check(self) -> dict:
        """``check`` with the control in the program's place."""
        return compare(*self.control(self.sample()))

    def check(self) -> dict:
        picks = self.sample()
        made = [(self.done[i][1], self.done[i][2]) for i in picks]
        return compare(made, self.gaussians(picks),
                       self.frames([g for g, _ in made]))
