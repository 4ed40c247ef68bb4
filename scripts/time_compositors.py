#!/usr/bin/env python3
"""Device times of the compositor kernels K2, K3, K2ᵇ and K3ᵇ of one
checkout, on one card.

Run from the root of a checkout, with one card visible:

    python3 scripts/time_compositors.py [--root DIR] [--tag NAME] [--variants]

It imports ``lgm_tpu_torch`` from DIR (default: this checkout; an
unpacked ``git archive`` of an older commit times that commit's kernels,
built under DIR/build/kernels), and times each kernel on three 512²
views:

- ``bench``: 65,536 splats from ``sample_scene(seed 0)``, view 0 of LGM
  big's 180-frame orbit (``chip_smoke.py``'s bench scene);
- ``frame0``: the same orbit view of the 65,536 Gaussians that LGM big
  with seeded random weights makes from four views of
  ``sample_scene(seed 1)`` (``chip_smoke.py``'s inference phase, frame 0:
  large splats, tiles full to MPT, as the training step's supervision
  views);
- ``train``: scene 0, view 0 of a synthetic LGM-big batch (512 splats,
  ``make_batch``'s streams at seed (0, 0)), as the batch's ground-truth
  renders.

K2 runs as inference runs it (R = 10, no state) and as training runs it
(R = 9, writing its chunk-boundary state); K3 without and with its state;
K2ᵇ and K3ᵇ from that state. Each time is the median of 10 samples of 10
calls back to back (``ms``, device time) beside the median of 10 single
calls (``one_call_ms``, host enqueue included). With ``--variants`` (a
checkout whose ``flatsort`` has ``VARIANTS``), K2 and K3 also at every
built (cluster size, pixels a thread). Prints the card's name and power
limit, then one JSON line per time. To compare two checkouts on one card,
run them in turns in one call: old, new, new, old.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def views(dev):
    """name -> (gaussians, view camera) of the three timed views."""
    import numpy as np
    import torch

    from lgm_tpu_torch import infer
    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.data.synthetic import sample_poses, sample_scene
    from lgm_tpu_torch.ops.gsplat.api import render_views
    from lgm_tpu_torch.utils import camera

    opt = CONFIGS["big"]
    view0 = infer.orbit_video_cameras(opt, 180)["cam_view"][0]
    out = {"bench": (sample_scene(np.random.default_rng(0), 65536), view0)}
    # chip_smoke.py's phase_main: four input views rendered from a seeded
    # scene, through LGM big with seeded random weights.
    tan = float(np.tan(0.5 * np.deg2rad(opt.fovy)))
    _, poses = camera.default_plucker_embedding(opt)
    cams = camera.build_camera_inputs(poses, opt.fovy, opt.znear, opt.zfar)
    g = torch.as_tensor(sample_scene(np.random.default_rng(1), 65536),
                        device=dev)
    with torch.inference_mode():
        mv = render_views(g[None], torch.as_tensor(cams["cam_view"],
                                                   device=dev)[None],
                          opt.input_size, tan, dup=32)["image"][0]
    model = infer.load_model(opt, device=str(dev))
    out["frame0"] = (infer.forward_gaussians(model, mv.cpu().numpy())[0],
                     view0)
    del model
    rng = np.random.default_rng((0, 0))
    B = 2  # the batch chip_smoke.py trains
    scenes = [sample_scene(rng, 512) for _ in range(B)]
    poses = [sample_poses(rng, opt) for _ in range(B)]
    cams = camera.build_camera_inputs(poses[0], opt.fovy, opt.znear,
                                      opt.zfar)
    out["train"] = (scenes[0], cams["cam_view"][0])
    return {k: (torch.as_tensor(g, device=dev),
                torch.as_tensor(v, dtype=torch.float32, device=dev))
            for k, (g, v) in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_compositors: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import cuda_ms  # noqa: E402  (this checkout's timer)

    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np

    from lgm_tpu_torch.config import CONFIGS
    from lgm_tpu_torch.ops.gsplat import flatsort as fs
    from lgm_tpu_torch.ops.gsplat import tiled

    tag = args.tag or os.path.abspath(args.root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"tree": tag, "package": fs.__file__, "card": smi}),
          flush=True)
    dev = torch.device("cuda", 0)
    tan = float(np.tan(0.5 * np.deg2rad(CONFIGS["big"].fovy)))
    S, th, tw = 512, 32, 32

    def emit(kernel, view, fn, variant=None, **extra):
        ms = cuda_ms(fn, launches=10)
        one = cuda_ms(fn)
        print(json.dumps({"tree": tag, "kernel": kernel, "view": view,
                          "variant": variant, "ms": ms, "one_call_ms": one,
                          **extra}), flush=True)

    for name, (g, view) in views(dev).items():
        with torch.no_grad():
            p10, c10 = fs._prepare_view(g, view, S, tan, 1.0, th, tw, 32,
                                        1024, True)
            p9, c9 = fs._prepare_view(g, view, S, tan, 1.0, th, tw, 32,
                                      1024, False)
            t_args = tiled._prepare_view(g, view, S, tan, 1.0, th, tw, 1024)
            k2 = (p10, c10, th, tw, S // tw)
            k2s = (p9, c9, th, tw, S // tw)
            fo, state = fs.composite_fwd(*k2s, return_state=True)
            go = torch.as_tensor(np.random.default_rng(1).normal(
                0, 1, tuple(fo.shape)), dtype=torch.float32, device=dev)
            tfo, tstate = tiled.tile_composite_fwd(*t_args, return_state=True)
            tgo = torch.as_tensor(np.random.default_rng(1).normal(
                0, 1, tuple(tfo.shape)), dtype=torch.float32, device=dev)
            emit("K2", name, lambda: fs.composite_fwd(*k2),
                 slots=int(c10.sum()))
            emit("K2 with state", name,
                 lambda: fs.composite_fwd(*k2s, return_state=True))
            emit("K2b", name, lambda: fs.composite_bwd(
                p9, c9, fo, go, th, tw, S // tw, state=state))
            emit("K3", name, lambda: tiled.tile_composite_fwd(*t_args))
            emit("K3 with state", name, lambda: tiled.tile_composite_fwd(
                *t_args, return_state=True))
            emit("K3b", name, lambda: tiled.tile_composite_bwd(
                *t_args, tfo, tgo, tstate))
            if args.variants:
                default2, default3 = fs.K2_VARIANT, tiled.K3_VARIANT
                for v in fs.VARIANTS:
                    fs.K2_VARIANT = tiled.K3_VARIANT = v
                    emit("K2", name, lambda: fs.composite_fwd(*k2),
                         variant=list(v))
                    emit("K3", name, lambda: tiled.tile_composite_fwd(
                        *t_args), variant=list(v))
                fs.K2_VARIANT, tiled.K3_VARIANT = default2, default3
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
