"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source of ``csrc/`` into one shared library with a
plain C interface, which is loaded with ctypes (no PyTorch headers, so a
build takes seconds). The library lands in ``build/torch_kernels/<key>/``
beside the package, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. Only the sources in this
checkout are built; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

#: sm_90a: Hopper. -fmad=false keeps every multiply and add separately
#: rounded, as in the plain torch versions the kernels are held against.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types; each returns a cudaError_t.
SIGNATURES = {
    "mcpt_nearest": (_P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P),
    "mcpt_occluded": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _P),
    "mcpt_arvo_select": (_P, _P, _P, _P, _I, _I, _P, _P, _P),
    "mcpt_nearest_culled": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                            _P, _P, _P, _P, _P),
    "mcpt_occluded_culled": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P),
}


class KernelLibrary:
    """The loaded library, the nvcc log of its build and the build time
    (0 when an existing build was reused)."""

    def __init__(self, path: Path, log: str, seconds: float):
        self.path = path
        self.log = log
        self.build_seconds = seconds
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


_LIB: KernelLibrary | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME) on this machine")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load() -> KernelLibrary:
    """The kernel library, compiled first if this source state has no
    build yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out_dir = BUILD_ROOT / build_key()
    lib_path = out_dir / "libmcpt_kernels.so"
    if lib_path.exists():
        _LIB = KernelLibrary(lib_path, "", 0.0)
        return _LIB
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib_path)
    _LIB = KernelLibrary(lib_path, log, seconds)
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
