"""scripts/eval_convert_quality_torch.py, the port's converter-quality
script, on the CPU: its shape builders, analytic surfaces, surface
samplers, budgets and extents equal lgm_tpu's script's
(scripts/eval_convert_quality.py, loaded by path here) bit for bit, and
the script runs end to end at tiny overrides, writing a row with
lgm_tpu's keys plus the device and the card."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    env = dict(os.environ)
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        # lgm_tpu's script sets a JAX cache directory and both put the
        # repository on sys.path at import: keep neither.
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


ours = _load("eval_convert_quality_torch")
ref = _load("eval_convert_quality")


@pytest.mark.parametrize("n", [500, 6000])
@pytest.mark.parametrize("shape", ["torus", "cross"])
def test_gaussians_are_lgm_tpus(shape, n):
    np.testing.assert_array_equal(ours.SHAPES[shape][0](n),
                                  ref.SHAPES[shape][0](n))
    np.testing.assert_array_equal(ours.SHAPES[shape][0](n, seed=3),
                                  ref.SHAPES[shape][0](n, seed=3))


@pytest.mark.parametrize("shape", ["torus", "cross"])
def test_surfaces_and_sdfs_are_lgm_tpus(shape):
    pts_ours = ours.SHAPES[shape][2](3000)
    pts_ref = ref.SHAPES[shape][2](3000)
    np.testing.assert_array_equal(pts_ours, pts_ref)
    probe = np.random.default_rng(4).uniform(-0.7, 0.7, (4000, 3)).astype(
        np.float32)
    for p in (probe, pts_ref):
        np.testing.assert_array_equal(ours.SHAPES[shape][1](p),
                                      ref.SHAPES[shape][1](p))
    assert ours.SHAPES[shape][3] == ref.SHAPES[shape][3]
    # Surface samples lie on the analytic surface.
    assert np.abs(ours.SHAPES[shape][1](pts_ours)).max() < 1e-4


def test_mesh_sampler_and_budgets_are_lgm_tpus():
    rng = np.random.default_rng(5)
    verts = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (100, 3))
    for n, seed in ((20000, 2), (777, 9)):
        np.testing.assert_array_equal(
            ours.sample_mesh_surface(verts, faces, n, seed),
            ref.sample_mesh_surface(verts, faces, n, seed))
    assert ours.BUDGETS == ref.BUDGETS


def test_script_runs_end_to_end_on_the_cpu(tmp_path):
    """The script at tiny overrides on the CPU (the converter's code paths
    at small sizes; ~15 s): a row with the keys of lgm_tpu's committed
    rows plus ``device`` and ``card``, appended to ``--out``."""
    out = tmp_path / "rows.jsonl"
    cmd = [sys.executable, os.path.join(ROOT, "scripts",
                                        "eval_convert_quality_torch.py"),
           "--device", "cpu", "--shape", "cross", "--budget", "quick",
           "--n-gaussians", "1000", "--nerf-iters", "16", "--mesh-iters",
           "2", "--tex-iters", "2", "--grid", "40", "--n-rays", "256",
           "--size", "64", "--tex-size", "128", "--out", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1",
                                             PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    with open(os.path.join(ROOT, "benchmarks",
                           "convert_quality_torus.jsonl")) as fh:
        ref_rows = [json.loads(line) for line in fh]
    assert set(ref_rows[-1]) <= set(row)
    assert row["device"] == "cpu" and row["card"] is None
    assert (row["shape"], row["budget"]) == ("cross", "quick")
    assert row["iters"] == [16, 2, 2] and row["grid"] == 40
    assert row["n_faces"] > 0 and 0 < row["chamfer"] < 0.5
    assert np.isfinite(row["psnr_mesh_vs_gs"]) and row["fit_seconds"] > 0
    assert row["chamfer_pct_of_extent"] == pytest.approx(
        row["chamfer"] / ref.SHAPES["cross"][3] * 100)
