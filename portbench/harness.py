"""One run of one cell: find its files by name, set it up, measure the
window, read the metrics, check the outputs, and build the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the names in
``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration as it is run (the preset's
  ``Options`` written out) with its source, ``reduced`` and ``assumed``;
- ``workloads/<cell>.json``: the cell's configuration, traffic mix and its
  parameters, and the limits of its output check;
- ``traffic/<mix>.py``: a ``Cell`` class (set-up, window, end-to-end
  metrics, output check) for each traffic mix;
- ``metrics/<family>.py``: a ``read(timeline, reading)`` for each
  per-layer metric family (the part of the name before the first dot;
  ``reading`` is what the cell's ``Cell.reading`` says of its window),
  which returns ``None`` where the traced window holds nothing for it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may load: the JAX reference package
# and JAX itself (compared whole, so the port's own name passes).
BANNED = ("jax", "jaxlib", "flax", "lgm_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules(modules=None) -> list:
    """The loaded modules whose top-level name is banned."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in BANNED})


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports: those listing it, or listing no cells."""
    def mine(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and m["moves"] in names]
    return e2e, layer


@dataclass
class Context:
    """What a traffic mix's ``Cell`` is given: the configuration (its
    ``options``, the preset's fields), the cell's traffic ``mix``, its
    ``traffic`` parameters, ``limits`` and ``chips``, the seed and the
    device."""

    name: str
    mix: str
    chips: int
    options: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: str


@dataclass
class Window:
    """What a window measured: ``units`` (steps or objects completed),
    ``attempted``, ``failed``, ``seconds`` (host clock, to the sync of the
    last whole unit) and ``spans`` (the benchmark's own host spans, name
    -> seconds of each)."""

    units: int
    attempted: int
    failed: int
    seconds: float
    spans: Dict[str, list] = field(default_factory=dict)


def build_context(cell: str, seed: int, device: str,
                  options: Optional[dict] = None,
                  traffic: Optional[dict] = None) -> Context:
    """The cell's files by name; ``options`` / ``traffic`` override the
    configuration's and the cell's parameters (the CPU tests' small
    sizes)."""
    wl = load_json(HERE / "workloads" / f"{cell}.json")
    config = load_json(HERE / "configs" / f"{wl['config']}.json")
    opts = dict(config["options"], **(options or {}))
    params = dict(wl["params"], **(traffic or {}))
    return Context(cell, wl["traffic"], wl["chips"], opts, config, params,
                   wl["limits"], seed, device)


def traffic_module(mix: str):
    return load_module(HERE / "traffic" / f"{mix}.py",
                       f"portbench_traffic_{mix}")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "devices_seen": torch.cuda.device_count(),
            "power_limit": power_limit()}


def host_usage(since: Optional[tuple] = None) -> tuple:
    """(this process's CPU seconds, its involuntary context switches, the
    machine's stolen and total CPU jiffies from ``/proc/stat``), or with
    ``since`` the change from that reading. Where the host is slow, it
    tells a busier process from a busier machine."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        cpu = [0] * 8
    now = (ru.ru_utime + ru.ru_stime, ru.ru_nivcsw, cpu[7], sum(cpu))
    return now if since is None else tuple(a - b for a, b in
                                           zip(now, since))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             options: Optional[dict] = None,
             traffic: Optional[dict] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
             ) -> dict:
    """Run ``cell`` once and return its result line (a dict)."""
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    e2e_defs, layer_defs = cell_metrics(bench, cell)
    ctx = build_context(cell, seed, device, options, traffic)
    on_card = device == "cuda"
    runner = traffic_module(ctx.mix).Cell(ctx)
    runner.setup()
    setup_s = time.time() - t_start
    log(f"portbench: {cell} seed {seed}: set-up {setup_s:.2f} s")

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.start()
    host0 = host_usage()
    try:
        win = runner.window(seconds)
    finally:
        if prof is not None:
            prof.stop()
    cpu_s, switches, steal, jiffies = host_usage(host0)
    log(f"portbench: window {win.seconds:.3f} s, {win.units} units; "
        f"process CPU {cpu_s:.1f} s, {switches} involuntary switches, "
        f"machine's CPU stolen {100 * steal / max(jiffies, 1):.2f}%")
    for name, values in win.spans.items():
        q = sorted(values)
        if q:
            log(f"portbench: span {name} n {len(q)} min {q[0]:.3f} "
                f"median {q[len(q) // 2]:.3f} max {q[-1]:.3f} s")
    e2e = runner.end_to_end(win)
    e2e["setup_s"] = setup_s
    peak = max(getattr(runner, "setup_peak", 0),
               torch.cuda.max_memory_allocated()) if on_card else 0
    device_rec = device_info(ctx.chips) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    device_rec["memory_peak_bytes"] = int(peak)

    metrics = {}
    breakdown = None
    if trace:
        from portbench.timeline import from_profiler

        t0 = time.time()
        tl = from_profiler(prof)
        prof = None
        reading = runner.reading(win)
        for m in layer_defs:
            family = m["name"].split(".")[0]
            reader = load_module(HERE / "metrics" / f"{family}.py",
                                 f"portbench_metric_{family}")
            value = reader.read(tl, reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_rec["busy_s"] = tl.busy_s()
        device_rec["window_s"] = tl.window_s
        breakdown = {"device_ops": tl.device_ops(),
                     "idle_gaps": tl.idle_gaps()}
        log(f"portbench: trace read in {time.time() - t0:.1f} s")
    else:
        for m in e2e_defs:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    runner.release()
    t0 = time.time()
    numbers = runner.check()
    log(f"portbench: check took {time.time() - t0:.1f} s")
    checks = {k: {"value": v, "limit": ctx.limits[k]}
              for k, v in numbers.items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()) and win.failed == 0
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
