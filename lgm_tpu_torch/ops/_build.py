"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``lgm_tpu_torch/**/csrc/<name>.cu`` is one kernel with a plain C
interface: no PyTorch headers, so ``nvcc`` takes seconds, not minutes. At
first use it is compiled for Hopper (``sm_90a``) into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed by a
hash of the source and the flags, and loaded with ``ctypes``. Each C entry
returns ``cudaGetLastError()`` after its launch; ``check`` raises when it
is not 0. A failed build raises: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source, for every csrc of the package."""
    return {p.stem: p for p in sorted(PACKAGE_DIR.glob("**/csrc/*.cu"))}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a host with the "
            "CUDA toolkit (CPU tensors take the plain versions instead)")
    return path


def target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns name -> .so.
    The ptxas report (registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out = {name: target(srcs[name]) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        so = out[name]
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in running:
        log, _ = proc.communicate()
        so.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load kernel ``name``; ``signatures`` maps each
    C function to (argtypes, restype)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.kernel_error_name.argtypes = [ctypes.c_int]
            lib.kernel_error_name.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.kernel_error_name(err).decode()})")
