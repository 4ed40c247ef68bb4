"""Package boundary of lgm_tpu_torch: it and chip_smoke.py import neither
JAX nor lgm_tpu, and the kernel build finds every csrc source."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import lgm_tpu_torch
for m in pkgutil.walk_packages(lgm_tpu_torch.__path__, "lgm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "lgm_tpu"))
print("BAD", bad)
print("MODULES", len([m for m in sys.modules if m.startswith("lgm_tpu_torch")]))
"""


def test_port_imports_no_jax_and_no_lgm_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1])
    assert n >= 15, out.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|lgm_tpu)\b",
                     re.M)
    files = list((ROOT / "lgm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_kernel_sources_are_found_and_build_needs_nvcc(tmp_path,
                                                       monkeypatch):
    from lgm_tpu_torch.ops import _build

    srcs = _build.sources()
    assert set(srcs) == {"mha_fwd", "mha_bwd", "composite_fwd",
                         "composite_bwd"}
    assert all(p.suffix == ".cu" and p.parent.name == "csrc"
               for p in srcs.values())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    t = _build.target(srcs["mha_fwd"])
    assert t.parent == tmp_path / "kernels" and t.name.startswith("mha_fwd-")
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("this host has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["mha_fwd"])
    assert not (tmp_path / "kernels").exists()
