"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source of ``csrc/`` to an object, one process per
source and all at once, and links them into one shared library with a
plain C interface, which is loaded with ctypes (no PyTorch headers, so a
build takes seconds). The library lands in ``build/torch_kernels/<key>/``
beside the package, keyed by a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so a changed source or header rebuilds and
an unchanged tree is reused. Only the sources in this
checkout are built; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

#: sm_90a: Hopper. -fmad=false keeps every multiply and add separately
#: rounded, as in the plain torch versions the kernels are held against;
#: K1 / K2 fuse their dots explicitly (__fmaf_rn), which the flag leaves be.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _LL, _ULL = ctypes.c_uint, ctypes.c_longlong, ctypes.c_ulonglong
#: C entry points and their argument types; each returns a cudaError_t.
SIGNATURES = {
    # K1 / K2: ..., fma (1: fused dots), stream
    "mcpt_nearest": (_P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _I, _P),
    "mcpt_occluded": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _I, _P),
    # K3: x, n, u, consts, N, L, R (uniforms a point), idx, wsum, stream
    "mcpt_arvo_select": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    # K4 / K5: ..., nrt, nb, tile, real rows, t_eps, outputs, fma, stream
    "mcpt_nearest_culled": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                            _P, _P, _P, _P, _I, _P),
    "mcpt_occluded_culled": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _P),
    # K6: key, data, data is int64, scalar data, 13 batch values, total, out, stream
    "mcpt_threefry_fold": (_P, _P, _I, _U, _P, _LL, _P, _P),
    # K6: key, key row stride, word stride, n, start, total, mode, lo, span, out, stream
    "mcpt_threefry_bits": (_P, _LL, _LL, _LL, _ULL, _LL, _I, _F, _F, _P, _P),
    # The fused MIS vertex (vertex.cu): inputs, sizes and flags, outputs, stream
    "mcpt_vertex_emit": (_P,) * 12 + (_I, _P, _P, _F, _F, _I) + (_P,) * 6,
    "mcpt_vertex_light_brdf": (_P,) * 12 + (_I, _I, _I) + (_P,) * 10,
    "mcpt_vertex_nee_add": (_P, _P, _P, _P, _I, _P),
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
    """The hash of the flags and of every source and header of ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
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
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        nvcc, srcs = _nvcc(), _sources()
        objs = [work / f"{src.stem}.o" for src in srcs]
        t0 = time.perf_counter()
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for o, src in zip(objs, srcs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        if all(p.returncode == 0 for p in procs):
            cmds.append([nvcc, "-shared", "-o", str(work / lib_path.name), *map(str, objs)])
            procs.append(subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
            outs.append(procs[-1].stdout)
        seconds = time.perf_counter() - t0
        for c, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
        os.replace(work / lib_path.name, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log = "".join(outs)
    _LIB = KernelLibrary(lib_path, log, seconds)
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_tensors(name: str, n: int, **tensors) -> torch.device:
    """Each of ``tensors``, given as (tensor, dtype, shape with -1 for ``n``
    rows), on one CUDA device, of that dtype and shape and contiguous;
    returns the device. ``name`` is the wrapper's, for the message."""
    dev = None
    for k, (t, dtype, shape) in tensors.items():
        dev = t.device if dev is None else dev
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}: the kernel takes CUDA tensors")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} must be {dtype}, got {t.dtype}")
        want = tuple(n if s == -1 else s for s in shape)
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous {want}, got {tuple(t.shape)}")
    return dev


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream, for a C entry point."""
    return torch.cuda.current_stream(dev).cuda_stream
