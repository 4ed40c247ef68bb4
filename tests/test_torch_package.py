"""Package boundary of lgm_tpu_torch: it and chip_smoke.py import neither
JAX nor lgm_tpu, nor any package the card host lacks (transformers, cv2,
regex, diffusers, ftfy, rembg), and the kernel build finds every csrc
source."""

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
required = ("lgm_tpu_torch.io.png", "lgm_tpu_torch.io.jpeg",
            "lgm_tpu_torch.io.image", "lgm_tpu_torch.data.decode",
            "lgm_tpu_torch.data.provider", "lgm_tpu_torch.parallel.dist",
            "lgm_tpu_torch.utils.augment", "lgm_tpu_torch.diffusion.data",
            "lgm_tpu_torch.diffusion.train", "lgm_tpu_torch.convert",
            "lgm_tpu_torch.ops.hashgrid", "lgm_tpu_torch.ops.raymarch",
            "lgm_tpu_torch.ops.trirast", "lgm_tpu_torch.io.mesh",
            "lgm_tpu_torch.native", "lgm_tpu_torch.apps.app",
            "lgm_tpu_torch.apps.viewer")
print("MISSING", [m for m in required if m not in sys.modules])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "lgm_tpu",
                                    "transformers", "cv2", "regex",
                                    "diffusers", "ftfy", "rembg"))
print("BAD", bad)
print("MODULES", len([m for m in sys.modules if m.startswith("lgm_tpu_torch")]))
"""


def test_port_imports_no_jax_and_no_lgm_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "MISSING []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1])
    assert n >= 40, out.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|lgm_tpu)\b",
                     re.M)
    files = list((ROOT / "lgm_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "scripts" / "eval_convert_quality_torch.py",
              ROOT / "scripts" / "time_attention.py",
              ROOT / "scripts" / "vp_activation_bytes.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_host_sources_include_no_image_library():
    """The PNG unfilter and the JPEG decoder are the port's own code: the
    host C++ includes the standard C++ library only (no libjpeg, libpng,
    zlib or OpenCV header), so it builds where none is installed."""
    srcs = sorted((ROOT / "lgm_tpu_torch").rglob("csrc/*.cpp"))
    assert {p.name for p in srcs} >= {"png_unfilter.cpp", "jpeg_decode.cpp"}
    for src in srcs:
        headers = re.findall(r'^#include\s*[<"]([^>"]+)', src.read_text(),
                             re.M)
        # Standard C++ headers have no extension; a library's have one.
        assert headers and all("." not in h for h in headers), (src,
                                                                 headers)


def test_kernel_sources_are_found_and_build_needs_nvcc(tmp_path,
                                                       monkeypatch):
    from lgm_tpu_torch.ops import _build

    srcs = _build.sources()
    assert set(srcs) == {"mha_fwd_wgmma", "mha_bwd_wgmma", "mha_fwd_f32",
                         "mha_bwd_f32", "mha_split_tf32", "composite_fwd",
                         "composite_bwd", "tiled_fwd", "tiled_bwd",
                         "project_fwd", "project_bwd"}
    assert all(p.suffix == ".cu" and p.parent.name == "csrc"
               for p in srcs.values())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    t = _build.target(srcs["mha_fwd_wgmma"])
    assert t.parent == tmp_path / "kernels" and \
        t.name.startswith("mha_fwd_wgmma-")
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("this host has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["mha_fwd_wgmma"])
    assert not (tmp_path / "kernels").exists()
