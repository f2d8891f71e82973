"""K6: threefry2x32 on CUDA, one launch per ``fold_in``, ``random_bits`` or
``uniform`` call.

Not the counterpart of a Pallas kernel: on the TPU, XLA fused each threefry
call of ``monte_carlo_path_tracing_tpu/core/rng.py`` into one generated
kernel, while the port's plain version (``core/rng.py``: ``fold_in_plain``,
``random_bits_plain``, ``uniform_plain``) runs the 20 rounds as ~170 int64
torch ops. The CUDA source is ``csrc/rng.cu``; ``core/rng.py`` routes CUDA
keys here and CPU keys to the plain version.

Every launch is described first by its normalised arguments
(:func:`fold_launch`, :func:`bits_launch`): the broadcast batch as sizes
and element strides (a stride of 0 broadcasts, so nothing is materialised
at the batch's shape), or the keys as rows with a run of ``n`` counts each
from ``start``. :func:`threefry` hands them to the kernel;
:func:`fold_twin` and :func:`bits_twin` compute the same words from the
same arguments with the plain threefry, indexing as the kernel does, so
the CPU tests reach everything the wrapper does in Python.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
#: Dimensions of a fold's broadcast batch the kernel indexes.
MAX_DIMS = 4

#: ``mode`` of a bits launch: int64 words, uniforms on [0, 1), on [lo, lo + span).
BITS, UNIFORM, UNIFORM_RANGE = 1, 2, 3


class FoldLaunch(NamedTuple):
    """One fold_in launch: the output batch ``shape`` (the words are
    ``shape + (2,)``), the key and data as views at that shape (data None:
    the Python int ``scalar``), and the kernel's 13 batch values: sizes,
    key strides and data strides (each padded in front to MAX_DIMS) and
    the stride between the key's two words."""

    shape: tuple
    key: torch.Tensor
    data: torch.Tensor | None
    scalar: int
    args: tuple

    @property
    def total(self) -> int:
        return math.prod(self.shape)


class BitsLaunch(NamedTuple):
    """One random_bits / uniform launch: keys as ``rows`` [K, 2] (a view),
    each drawing the ``n`` counts start .. start + n - 1, into ``shape``
    (K * n elements); ``mode`` and the uniform range (lo, span) in f32."""

    shape: tuple
    rows: torch.Tensor
    n: int
    start: int
    mode: int
    lo: float
    span: float

    @property
    def total(self) -> int:
        return self.rows.shape[0] * self.n


def _check_key(key: torch.Tensor, name: str) -> None:
    if key.dtype != torch.int64 or key.dim() == 0 or key.shape[-1] != 2:
        raise TypeError(f"{name}: key must be int64 [..., 2], got {key.dtype} {tuple(key.shape)}")


def fold_launch(key: torch.Tensor, data) -> FoldLaunch:
    """The normalised arguments of ``fold_in(key, data)``: key [..., 2]
    against a Python int or an integer tensor, broadcast together."""
    _check_key(key, "fold_in")
    if torch.is_tensor(data):
        if data.device != key.device:
            raise ValueError(f"fold_in: data on {data.device}, key on {key.device}")
        if data.dtype not in (torch.int32, torch.int64):
            if data.dtype.is_floating_point or data.dtype.is_complex:
                raise TypeError(f"fold_in: data must be an integer tensor, got {data.dtype}")
            data = data.to(torch.int64)
        shape = tuple(torch.broadcast_shapes(key.shape[:-1], data.shape))
        data = data.expand(shape)
        scalar = 0
    else:
        shape, scalar, data = tuple(key.shape[:-1]), int(data) & _M32, None
    if len(shape) > MAX_DIMS:
        raise ValueError(f"fold_in: batch {shape} has more than {MAX_DIMS} dimensions")
    key = key.expand(shape + (2,))
    pad = [0] * (MAX_DIMS - len(shape))
    dstride = list(data.stride()) if data is not None else [0] * len(shape)
    args = ([1] * len(pad) + list(shape) + pad + list(key.stride()[:-1]) + pad + dstride
            + [key.stride(-1)])
    return FoldLaunch(shape=shape, key=key, data=data, scalar=scalar, args=tuple(args))


def bits_launch(key: torch.Tensor, shape, row_offset: int = 0, uniform=None) -> BitsLaunch:
    """The normalised arguments of ``random_bits(key, shape, row_offset)``
    (``uniform`` None) or of ``uniform(key, shape, *uniform, row_offset)``
    (``uniform`` = (minval, maxval)). A scalar key [2] draws ``shape``
    from count ``row_offset * prod(shape[1:])``; keys [..., 2] draw
    ``shape`` each from count 0 (random_bits), or ``shape[1:]`` each where
    ``shape[0]`` is their count (uniform)."""
    _check_key(key, "random_bits")
    shape = tuple(int(s) for s in shape)
    if key.dim() > 1 and uniform is not None:
        if shape[0] != key.shape[0]:
            raise ValueError(f"batched key {tuple(key.shape)} vs shape {shape}")
        shape = shape[1:]
    n = math.prod(shape)
    if key.dim() == 1:
        rows, start, out = key.unsqueeze(0), int(row_offset) * math.prod(shape[1:]), shape
    else:
        rows, start, out = key.reshape(-1, 2), 0, tuple(key.shape[:-1]) + shape
    mode, lo, span = BITS, 0.0, 1.0
    if uniform is not None:
        minval, maxval = uniform
        mode = UNIFORM
        if not (minval == 0.0 and maxval == 1.0):
            mode = UNIFORM_RANGE
            lo = float(np.float32(minval))
            span = float(np.float32(maxval) - np.float32(lo))   # jax subtracts in f32
    if start < 0 or start + n > 1 << 64:
        raise ValueError(f"random_bits: counts [{start}, {start + n}) outside uint64")
    return BitsLaunch(shape=out, rows=rows, n=n, start=start, mode=mode, lo=lo, span=span)


def _flat(t: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Elements of ``t``'s storage at element ``offsets`` from its first
    element (the kernel's pointer arithmetic)."""
    span = int(offsets.max()) + 1 if offsets.numel() else 1
    return torch.as_strided(t, (span,), (1,))[offsets]


def fold_twin(f: FoldLaunch) -> torch.Tensor:
    """The plain version of a fold launch, on its normalised arguments:
    int64 words ``f.shape + (2,)``."""
    from monte_carlo_path_tracing_tpu_torch.core.rng import threefry2x32

    if f.total == 0:
        return torch.empty(f.shape + (2,), dtype=torch.int64, device=f.key.device)
    size, ks, ds, kw = f.args[0:4], f.args[4:8], f.args[8:12], f.args[12]
    rest = torch.arange(f.total, dtype=torch.int64, device=f.key.device)
    koff = torch.zeros_like(rest)
    doff = torch.zeros_like(rest)
    for d in range(MAX_DIMS - 1, -1, -1):
        i = rest % size[d]
        rest = rest // size[d]
        koff += i * ks[d]
        doff += i * ds[d]
    k0 = _flat(f.key, koff) & _M32
    k1 = _flat(f.key, koff + kw) & _M32
    x1 = f.scalar if f.data is None else _flat(f.data, doff).to(torch.int64) & _M32
    y0, y1 = threefry2x32(k0, k1, 0, x1)
    return torch.stack([y0, y1], dim=-1).reshape(f.shape + (2,))


def bits_twin(b: BitsLaunch) -> torch.Tensor:
    """The plain version of a bits launch, on its normalised arguments:
    int64 words (random_bits) or f32 uniforms of ``b.shape``."""
    from monte_carlo_path_tracing_tpu_torch.core.rng import threefry2x32

    dev = b.rows.device
    if b.total == 0:
        return torch.empty(b.shape, dtype=torch.int64 if b.mode == BITS else torch.float32,
                           device=dev)
    t = torch.arange(b.total, dtype=torch.int64, device=dev)
    j = t // b.n
    count = b.start + (t - j * b.n)       # int64: counts below 2**63
    ks, kw = b.rows.stride(0), b.rows.stride(1)
    k0 = _flat(b.rows, j * ks) & _M32
    k1 = _flat(b.rows, j * ks + kw) & _M32
    y0, y1 = threefry2x32(k0, k1, count >> 32, count & _M32)
    bits = (y0 ^ y1).reshape(b.shape)
    if b.mode == BITS:
        return bits
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if b.mode == UNIFORM:
        return f
    return torch.clamp(f * b.span + b.lo, min=b.lo)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def threefry(launch) -> torch.Tensor:
    """K6 on a :class:`FoldLaunch` or :class:`BitsLaunch` of CUDA tensors:
    one launch (none for an empty batch), the output allocated here."""
    key = launch.key if isinstance(launch, FoldLaunch) else launch.rows
    if key.device.type != "cuda":
        raise ValueError(f"threefry (K6): tensors on {key.device}, not CUDA")
    if isinstance(launch, FoldLaunch):
        out = torch.empty(launch.shape + (2,), dtype=torch.int64, device=key.device)
    else:
        dtype = torch.int64 if launch.mode == BITS else torch.float32
        out = torch.empty(launch.shape, dtype=dtype, device=key.device)
    if launch.total == 0:
        return out
    lib = _build.load()
    if isinstance(launch, FoldLaunch):
        d = launch.data
        args = (ctypes.c_longlong * 13)(*launch.args)
        err = lib.mcpt_threefry_fold(
            key.data_ptr(), None if d is None else d.data_ptr(),
            int(d is not None and d.dtype == torch.int64), launch.scalar, args, launch.total,
            out.data_ptr(), _stream(key))
    else:
        err = lib.mcpt_threefry_bits(
            key.data_ptr(), key.stride(0), key.stride(1), launch.n, launch.start, launch.total,
            launch.mode, launch.lo, launch.span, out.data_ptr(), _stream(key))
    _build.check(err, "threefry (K6)")
    threefry.launches += 1
    return out


threefry.launches = 0


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``core.rng.fold_in`` on CUDA: one K6 launch."""
    return threefry(fold_launch(key, data))


def random_bits(key: torch.Tensor, shape, row_offset: int = 0) -> torch.Tensor:
    """``core.rng.random_bits`` on CUDA: one K6 launch."""
    return threefry(bits_launch(key, shape, row_offset))


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0, row_offset: int = 0):
    """``core.rng.uniform`` on CUDA: one K6 launch, the f32 conversion and
    the range fused."""
    return threefry(bits_launch(key, shape, row_offset, uniform=(minval, maxval)))
