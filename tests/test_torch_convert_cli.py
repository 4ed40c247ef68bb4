"""The mesh converter's command line (python -m lgm_tpu_torch.convert) in
a subprocess on the CPU; in a file of its own so that the test runner can
run it beside tests/test_torch_convert.py."""

import os
import subprocess
import sys

import numpy as np

from lgm_tpu_torch.io.mesh import load_glb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ball(n=300, seed=0):
    """tests/test_convert.py's ball of Gaussians."""
    rng = np.random.default_rng(seed)
    g = np.zeros((n, 14), np.float32)
    v = rng.normal(0, 1, (n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    g[:, 0:3] = v * rng.uniform(0, 0.4, (n, 1)) ** (1 / 3)
    g[:, 3] = 0.95
    g[:, 4:7] = 0.08
    g[:, 7] = 1.0
    g[:, 11:14] = np.abs(v) * 0.7 + 0.2
    return g


def test_convert_cli(tmp_path):
    """The convert command line on a .ply, on the CPU, in a subprocess:
    ``main`` with the tiny run's iterations (and its 512 rays an
    iteration, set before ``main`` runs), then ``-m`` for its help."""
    from lgm_tpu_torch.io.ply import save_ply

    ply = str(tmp_path / "ball.ply")
    save_ply(ball(), ply)
    out = str(tmp_path / "ball.glb")
    argv = ["nano", "--test-path", ply, "--out", out, "--nerf-iters", "24",
            "--mesh-iters", "2", "--tex-iters", "2", "--grid-resolution",
            "48", "--device", "cpu"]
    code = ("import sys; from lgm_tpu_torch import convert; "
            "convert.N_RAYS = 512; convert.main(sys.argv[1:])")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[export] wrote" in proc.stdout
    verts, faces, uv, tex = load_glb(out)
    assert len(faces) > 0 and tex[:8] == b"\x89PNG\r\n\x1a\n"
    proc = subprocess.run([sys.executable, "-m", "lgm_tpu_torch.convert",
                           "--help"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "--device" in proc.stdout
