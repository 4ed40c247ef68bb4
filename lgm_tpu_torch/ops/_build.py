"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``lgm_tpu_torch/**/csrc/<name>.cu`` is one kernel with a plain C
interface: no PyTorch headers, so ``nvcc`` takes seconds, not minutes. At
first use it is compiled for Hopper (``sm_90a``) into
``build/kernels/<name>-<hash>.so`` at the root of the checkout, keyed by a
hash of the source, the ``*.cuh`` headers beside it and the flags, and
loaded with ``ctypes``. Each C entry
returns ``cudaGetLastError()`` after its launch; ``check`` raises when it
is not 0. A failed build raises: nothing falls back to a plain version.

``build_host`` does the same for host C++ (``**/csrc/*.cpp``, no CUDA)
with the host compiler, into ``build/host/``.
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *sorted(src.parent.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


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


HOST_BUILD_DIR = PACKAGE_DIR.parent / "build" / "host"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def host_target(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update(src.read_bytes())
    return HOST_BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_host(src: Path) -> Path:
    """Compile a host C++ source (plain C interface, no CUDA) with the
    host compiler into ``build/host/<name>-<hash>.so``, keyed by a hash of
    the source and the flags, unless it is built already; returns the
    library. A failed build raises."""
    so = host_target(src)
    if so.exists():
        return so
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler to build {src.name}")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {src.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def short_name(mangled: str) -> str:
    """A kernel's mangled symbol as its name and integer template
    arguments, ``mha_fwd_kernel<32,2,4>``: the last length-prefixed name
    in it that ends in ``kernel`` (digits inside a name included, as in
    ``mha_bwd_dq_f32_kernel``)."""
    import re

    base = [m.group(2)[:int(m.group(1))] for m in
            re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled)
            if len(m.group(2)) >= int(m.group(1))
            and m.group(2)[:int(m.group(1))].endswith("kernel")]
    args = ",".join(re.findall(r"Li(\d+)E", mangled))
    return (base[-1] if base else mangled) + (f"<{args}>" if args else "")


def _sass(lib: Path) -> Optional[Dict[str, list]]:
    """Each kernel's SASS instructions in a built library, as (address,
    opcode with its modifiers, operands), from ``cuobjdump -sass``; None
    where the toolkit has no ``cuobjdump``."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kernels: Dict[str, list] = {}
    ops = None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            ops = kernels.setdefault(short_name(fn.group(1)), [])
            continue
        # The opcode and its modifiers (``HGMMA.64x32x8.F32.TF32``).
        op = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Za-z0-9_.]*)([^;]*)", line)
        if ops is not None and op:
            ops.append((int(op.group(1), 16), op.group(2), op.group(3)))
    return kernels


def sass_counts(lib: Path) -> Optional[Dict[str, Dict[str, int]]]:
    """Static counts of warp shuffles (``SHFL``) and shared-memory loads
    (``LDS*``, ``LDSM``) in each kernel of a built library, read from
    ``cuobjdump -sass``, in the whole kernel and in its longest loop (the
    instructions between a backward branch and its target: ``loop``,
    ``loop_SHFL``, ``loop_LDS``); None where the toolkit has no
    ``cuobjdump``."""
    import re

    kernels = _sass(lib)
    if kernels is None:
        return None

    def count(instrs):
        return {"SHFL": sum(op.split(".")[0] == "SHFL"
                            for _, op, _ in instrs),
                "LDS": sum(op.split(".")[0] in ("LDS", "LDSM")
                           for _, op, _ in instrs)}

    out: Dict[str, Dict[str, int]] = {}
    for kernel, instrs in kernels.items():
        out[kernel] = count(instrs)
        loops = []
        for addr, op, rest in instrs:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.split(".")[0] == "BRA" and target \
                    and int(target.group(1), 16) < addr:
                lo = int(target.group(1), 16)
                loops.append([i for i in instrs if lo <= i[0] <= addr])
        if loops:
            body = max(loops, key=len)
            inner = count(body)
            out[kernel].update(loop=len(body), loop_SHFL=inner["SHFL"],
                               loop_LDS=inner["LDS"])
    return out


def sass_mma_counts(lib: Path) -> Optional[Dict[str, Dict[str, int]]]:
    """Static counts of each kernel's tensor-core instructions in a built
    library: warpgroup products (``HGMMA``), those on TF32 operands
    (``HGMMA_TF32``), and Ampere's m16n8k8 ``mma.sync`` (``HMMA_1688``);
    None where the toolkit has no ``cuobjdump``."""
    kernels = _sass(lib)
    if kernels is None:
        return None
    return {kernel: {
        "HGMMA": sum(op.startswith("HGMMA") for _, op, _ in instrs),
        "HGMMA_TF32": sum(op.startswith("HGMMA") and ".TF32" in op
                          for _, op, _ in instrs),
        "HMMA_1688": sum(op.startswith("HMMA.1688") for _, op, _ in instrs)}
        for kernel, instrs in kernels.items()}


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.kernel_error_name(err).decode()})")
