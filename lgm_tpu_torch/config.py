"""Typed configuration for the PyTorch package.

The package's own copy of ``lgm_tpu/config.py`` (the port imports nothing
of the JAX package): the same frozen ``Options`` dataclass, the same
presets (ref: core/options.py:6-123) and the same argparse CLI pattern,
so the two packages read one preset identically. Fields that only the
TPU trainer reads (``unet_remat``, ``vp``, ``zero1``) are kept so a preset
means the same thing in both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class Options:
    # --- model -----------------------------------------------------------
    # U-Net input image resolution (ref: core/options.py:9-10).
    input_size: int = 256
    # U-Net ladder definition (ref: core/options.py:11-16).
    down_channels: Tuple[int, ...] = (64, 128, 256, 512, 1024, 1024)
    down_attention: Tuple[bool, ...] = (False, False, False, True, True, True)
    mid_attention: bool = True
    up_channels: Tuple[int, ...] = (1024, 1024, 512, 256)
    up_attention: Tuple[bool, ...] = (True, True, True, False)
    # U-Net output (splatter image) resolution (ref: core/options.py:17-18).
    splat_size: int = 64
    # Rendered/supervised view resolution (ref: core/options.py:19-20).
    output_size: int = 256

    # --- camera / dataset ------------------------------------------------
    fovy: float = 49.1           # degrees (ref: core/options.py:25-26)
    znear: float = 0.5
    zfar: float = 2.5
    num_views: int = 12          # input + supervision views per scene
    num_input_views: int = 4
    cam_radius: float = 1.5      # orbit radius; scene fits [-1,1]^3
    num_workers: int = 8

    # --- training --------------------------------------------------------
    workspace: str = "./workspace"
    resume: Optional[str] = None
    batch_size: int = 8          # per-replica batch
    gradient_accumulation_steps: int = 1
    lambda_lpips: float = 1.0
    # Converted LPIPS VGG weights (.npz from tools/convert_lpips.py);
    # None keeps the deterministic random-VGG init (see models/lpips.py).
    lpips_weights: Optional[str] = None
    gradient_clip: float = 1.0
    # Fog-collapse guard (off by default = reference loss parity). The
    # synthetic 2k-step protocol at peak lr 4e-4 can fall into a "fog"
    # basin: the model emits a near-constant screen-covering cloud
    # (opacity ~0.75, scale mean ~0.22) and per-splat gradients vanish
    # (BENCHMARKS.md round-4 diagnosis). This penalizes only the
    # pathology: mean(relu(scale - 0.1)) over activated scales, zero for
    # any splat smaller than 0.1 scene units, so a healthy model pays
    # nothing. Measured effect: see BENCHMARKS.md round-5 curve table.
    lambda_scale_reg: float = 0.0
    # Model compute dtype: "bf16" (reference training recipe,
    # acc_configs/gpu8.yaml) or "fp32". Rasterizer + loss stay f32
    # either way (see BENCHMARKS.md bf16-compositing note).
    mixed_precision: str = "bf16"
    lr: float = 4e-4
    prob_grid_distortion: float = 0.5
    prob_cam_jitter: float = 0.5
    # OneCycle warmup steps (ref: main.py:75-79 pct_start=3000/total).
    warmup_steps: int = 3000
    total_steps: int = 30_000    # schedule horizon (epochs x steps/epoch)
    # Eval + checkpoint cadence in steps (the reference evals/saves per
    # epoch, main.py:138-180, and per-1000-iters in the LVIS finetuner,
    # main1_lvis.py:239-283 — this generalizes both). Python-side only:
    # changing it never recompiles the step or eval graphs.
    eval_every: int = 1000

    # Rematerialize U-Net blocks on backward (keeps activation memory
    # within a 16 GB chip at reference batch sizes; see models/unet.py).
    unet_remat: bool = True

    # --- parallelism -----------------------------------------------------
    # View-parallel mesh axis: devices form a (dp, vp) mesh with
    # dp = device_count / vp. Supervision views shard over vp; the U-Net
    # runs with its (scene, input-view) axis sharded over dp x vp and the
    # per-view Gaussian slices all-gather along vp before rasterization.
    vp: int = 1
    # ZeRO-1: shard large optimizer-state leaves (Adam mu/nu) over dp.
    zero1: bool = False

    # --- rasterizer ------------------------------------------------------
    # Pallas tile size in pixels (rows x cols); cols aligned to TPU lanes.
    tile_h: int = 32
    tile_w: int = 32
    # Max Gaussians binned per tile (static shape cap for XLA); the
    # measured default of the flatsort kernel (BENCHMARKS.md).
    max_gaussians_per_tile: int = 1024
    # Per-splat live-tile cap of the flatsort binning (None = backend
    # default 16). TRAINING default 32, a measured round-4 choice
    # (BENCHMARKS.md "dup quality/cost"): at training configuration
    # dup=16 truncates renders vs the exact oracle (mean abs err 0.06
    # on model-output scenes, 0.003 on synthetic supervision scenes;
    # dup=32 halves both, dup=64 is oracle-clean), while the big-bs2
    # step cost of 32 is within noise of 16 (412 vs 417 ms/step) and
    # the small-preset curve cost is identical. dup=64 is NOT free:
    # 448.5 vs 386.5 ms/step at big-bs2 (r5 measurement, BENCHMARKS.md
    # dup table) — oracle-clean rendering costs +16% step time, so 64
    # stays an opt-in for quality-critical runs.
    rasterizer_dup: Optional[int] = 32
    # Rasterizer backend: "auto" | "pallas" | "xla".
    rasterizer: str = "auto"

    # --- testing / inference --------------------------------------------
    test_path: Optional[str] = None
    fancy_video: bool = False

    # Capture an XLA profiler trace (viewable in TensorBoard/Perfetto) of
    # steps [10, 10 + profile_steps) into <workspace>/trace. 0 = off.
    profile_steps: int = 0

    # Enable jax_debug_nans in the trainer: every primitive re-checks for
    # NaNs and raises at the producing op (slow; debugging only — the
    # reference ships no sanitizers at all, SURVEY.md §5.2).
    debug_nans: bool = False

    # Run one evaluation pass over the test split and exit (use with
    # --resume; reports eval loss/PSNR, the BASELINE.md eval metrics).
    eval_only: bool = False

    # --- data ------------------------------------------------------------
    data_mode: str = "synthetic"  # synthetic | objaverse | lvis
    data_path: Optional[str] = None
    data_path_rendering: Optional[str] = None

    @property
    def num_gaussians(self) -> int:
        """Total Gaussians per scene: one per splatter-image pixel per view."""
        return self.num_input_views * self.splat_size * self.splat_size

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)


# Named presets matching the reference CLI subcommands
# (ref: core/options.py:78-123).
CONFIGS = {
    "lrm": Options(),
    "small": Options(
        input_size=256, splat_size=64, output_size=256, batch_size=8,
    ),
    "big": Options(
        input_size=256,
        up_channels=(1024, 1024, 512, 256, 128),   # one more decoder block
        up_attention=(True, True, True, False, False),
        splat_size=128,
        output_size=512,
        batch_size=8,
        num_views=8,
    ),
    "tiny": Options(
        input_size=256,
        down_channels=(32, 64, 128, 256, 512),
        down_attention=(False, False, False, False, True),
        up_channels=(512, 256, 128),
        up_attention=(True, False, False),
        splat_size=64,
        output_size=256,
        batch_size=16,
        num_views=8,
    ),
    # Test-scale preset (not in the reference): tiny shapes for CI on CPU.
    "nano": Options(
        input_size=32,
        down_channels=(32, 64, 96),
        down_attention=(False, False, True),
        up_channels=(96, 64),
        up_attention=(True, False),
        splat_size=16,
        output_size=32,
        batch_size=2,
        num_views=4,
        num_input_views=2,
        tile_h=8,
        tile_w=32,
        max_gaussians_per_tile=256,
        lambda_lpips=0.0,
        warmup_steps=10,
        total_steps=100,
    ),
}


def get_config(name: str = "lrm", **overrides) -> Options:
    """Look up a preset by name, optionally overriding fields."""
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    opt = CONFIGS[name]
    return opt.replace(**overrides) if overrides else opt


def _add_options_args(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Options):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None)
        elif "Tuple" in str(f.type):
            parser.add_argument(name, type=str, default=None,
                                help="comma-separated list")
        else:
            parser.add_argument(name, type=str, default=None)


def _coerce(f: dataclasses.Field, raw: str):
    t = str(f.type)
    if "Tuple[int" in t:
        return tuple(int(x) for x in raw.split(","))
    if "Tuple[bool" in t:
        return tuple(x.lower() in ("1", "true", "yes") for x in raw.split(","))
    if "int" in t:
        return int(raw)
    if "float" in t:
        return float(raw)
    if "bool" in t:
        return bool(raw)
    return raw


def parse_cli(argv=None, default_config: str = "lrm") -> Options:
    """CLI pattern matching the reference: `prog <preset> --flag value`
    (ref: core/options.py:123, main.py:14)."""
    parser = argparse.ArgumentParser(description="lgm_tpu")
    parser.add_argument("config", nargs="?", default=default_config,
                        choices=sorted(CONFIGS))
    _add_options_args(parser)
    ns = parser.parse_args(argv)
    opt = CONFIGS[ns.config]
    overrides = {}
    for f in dataclasses.fields(Options):
        raw = getattr(ns, f.name, None)
        if raw is not None:
            overrides[f.name] = raw if not isinstance(raw, str) else _coerce(f, raw)
    return opt.replace(**overrides) if overrides else opt
