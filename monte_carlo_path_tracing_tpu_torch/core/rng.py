"""Counter-based RNG: a bit-exact torch port of jax's threefry2x32 streams.

Counterpart of ``monte_carlo_path_tracing_tpu/core/rng.py``. The renderers
fold one base key by (sample id, pixel id, bounce, purpose) so every
(pixel, sample) path owns its stream; the port consumes the SAME streams as
the JAX package, so images can be compared draw for draw.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of a jax
threefry key. torch lacks most uint32 ops, so all arithmetic runs in int64
with ``& 0xFFFFFFFF`` masks. What is reproduced (jax 0.9, with
``jax_threefry_partitionable=True``, jax/_src/prng.py and random.py):

- ``jax.random.key(seed)``: words ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(key, d)``: ``threefry2x32(key, (0, d))`` — the two output words
  are the new key;
- ``random_bits(key, 32, shape)``: counts are the 64-bit iota over
  ``shape`` split into (hi, lo) words; bits = ``out0 ^ out1``. A draw of
  a scalar key whose leading axis is rays takes its counts from the iota
  over the GLOBAL shape when jax partitions it over devices, so a shard
  of rows [r0, r0 + n) draws counts from ``r0 * prod(shape[1:])``: the
  ``row_offset`` keyword of the draws below (``render_rays_sharded``);
- ``uniform``: ``bitcast((bits >> 9) | 0x3F800000) - 1``, then
  ``max(minval, f * (maxval - minval) + minval)``;
- ``split(key, n)``: ``threefry2x32(key, (0, i))`` for i < n, the same
  words as ``fold_in(key, i)``;
- ``randint``: two 32-bit draws from the two halves of ``split(key)``,
  combined modulo the span with jax's ``2**32 mod span`` multiplier (the
  uint32 products wrap; here int64 with masks).

The int64 code above is the plain version (``fold_in_plain``,
``random_bits_plain``, ``uniform_plain``), which CPU keys run. Keys on
CUDA go to K6 (``ops/rng_cuda.py``, ``csrc/rng.cu``): one launch per
``fold_in``, ``random_bits`` or ``uniform`` call, bit-equal to the plain
version; ``split`` and ``randint`` reach it through those.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.ops import rng_cuda

# Purpose tags — one per independent random decision in the estimators.
P_LOBE = 0
P_BSDF = 1
P_LIGHT_SELECT = 2
P_LIGHT_WARP = 3
P_RR = 4
P_PIXEL_JITTER = 5

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 tensors (or Python
    ints) of uint32 values; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def base_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as a [2] int64 key."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def _on_card(key: torch.Tensor, name: str) -> bool:
    """True for K6 (a CUDA key), False for the plain version (a CPU key)."""
    if key.device.type == "cuda":
        return True
    if key.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {key.device}")


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` broadcast over batched keys and/or [N] data.

    (scalar key [2], scalar data) -> [2]; any [N] operand -> [N, 2]. Data is
    taken modulo 2**32, as jax's uint32 conversion does. CUDA keys: K6;
    CPU keys: :func:`fold_in_plain`."""
    if _on_card(key, "fold_in"):
        return rng_cuda.fold_in(key, data)
    return fold_in_plain(key, data)


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """The plain version of :func:`fold_in`: threefry in int64 torch ops."""
    d = data.to(torch.int64) & _M32 if torch.is_tensor(data) else int(data) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def lane_keys(key: torch.Tensor, lane_ids) -> torch.Tensor:
    """[N] per-lane stream keys: one fold of the lane (pixel/sample) id."""
    return fold_in(key, lane_ids)


def bounce_key(key: torch.Tensor, bounce, purpose: int) -> torch.Tensor:
    """Key(s) for one (bounce, purpose) decision."""
    return fold_in(fold_in(key, bounce), purpose)


def sample_key(key: torch.Tensor, sample_id) -> torch.Tensor:
    """Key for one spp chunk (sample index folded in)."""
    return fold_in(key, sample_id)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one [2] key: [num, 2] keys."""
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def random_bits(key: torch.Tensor, shape, row_offset: int = 0) -> torch.Tensor:
    """32-bit random words of ``shape`` per key (jax's partitionable
    ``random_bits``): a scalar key [2] gives ``shape``; a batched key
    [N, 2] gives ``[N, *shape]``, one independent draw per key.

    ``row_offset`` r0 makes a scalar key's draw rows [r0, r0 + shape[0])
    of the same draw over more rows, bit for bit: the counts start at
    ``r0 * prod(shape[1:])``. A batched key ignores it (each lane's draw
    is its own). CUDA keys: K6; CPU keys: :func:`random_bits_plain`."""
    if _on_card(key, "random_bits"):
        return rng_cuda.random_bits(key, shape, row_offset)
    return random_bits_plain(key, shape, row_offset)


def random_bits_plain(key: torch.Tensor, shape, row_offset: int = 0) -> torch.Tensor:
    """The plain version of :func:`random_bits`."""
    shape = tuple(shape)
    n = math.prod(shape)
    start = row_offset * math.prod(shape[1:]) if key.dim() == 1 else 0
    count = torch.arange(start, start + n, dtype=torch.int64, device=key.device).reshape(shape)
    hi, lo = (0, count) if start + n <= 1 << 32 else (count >> 32, count & _M32)
    k0 = key[..., 0].reshape(key.shape[:-1] + (1,) * len(shape))
    k1 = key[..., 1].reshape(key.shape[:-1] + (1,) * len(shape))
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0,
            row_offset: int = 0) -> torch.Tensor:
    """f32 uniform draw, bit-equal to ``jax.random.uniform``. A batched
    [N, 2] key draws ``shape[1:]`` per lane (``shape[0]`` must equal N);
    a scalar key's ``row_offset`` is :func:`random_bits`'s. CUDA keys: one
    K6 launch; CPU keys: :func:`uniform_plain`."""
    if _on_card(key, "uniform"):
        return rng_cuda.uniform(key, shape, minval, maxval, row_offset)
    return uniform_plain(key, shape, minval, maxval, row_offset)


def uniform_plain(key: torch.Tensor, shape, minval=0.0, maxval=1.0,
                  row_offset: int = 0) -> torch.Tensor:
    """The plain version of :func:`uniform`."""
    shape = tuple(shape)
    if key.dim() == 1:
        bits = random_bits_plain(key, shape, row_offset)
    else:
        if shape[0] != key.shape[0]:
            raise ValueError(f"batched key {tuple(key.shape)} vs shape {shape}")
        bits = random_bits_plain(key, shape[1:])
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f  # f * 1 + 0 and max(0, f) are exact no-ops
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)   # jax subtracts in f32
    return torch.clamp(f * span + float(lo), min=float(lo))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int64 draws in [minval, maxval) of ``shape`` from one [2] key,
    bit-equal to ``jax.random.randint(key, shape, minval, maxval,
    dtype=jnp.int32)`` for int32 bounds."""
    lo, hi = int(minval), int(maxval)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (hi - lo) & _M32 if hi > lo else 1
    multiplier = ((((1 << 16) % span) ** 2) & _M32) % span   # uint32: 2**32 wraps to 0
    offset = ((((higher % span) * multiplier) & _M32) + lower % span) & _M32
    return lo + offset % span


def pick_from_uniform(
    u: torch.Tensor, weights: torch.Tensor, weights_sum: torch.Tensor | None = None
) -> torch.Tensor:
    """Inverse-CDF pick with given uniforms ``u`` [N] against ``weights``
    ([L] shared or [N, L] per row): count(cdf <= u * total), clamped to
    L - 1 (the semantics of :func:`pick_weighted`). Against per-row
    weights ``u`` may be [R, N]: R picks a row from the one cdf, a count a
    round, shaped as ``u``."""
    cdf = torch.cumsum(weights, dim=-1)
    total = cdf[..., -1] if weights_sum is None else weights_sum
    if weights.dim() == 1:
        idx = (cdf[None, :] <= (u * total)[:, None]).sum(dim=-1)
    else:
        rounds = u if u.dim() == 2 else u[None]
        idx = torch.stack([(cdf <= (ur * total)[:, None]).sum(dim=-1)
                           for ur in rounds]).reshape(u.shape)
    return torch.clamp(idx, max=weights.shape[-1] - 1).to(torch.int32)


def pick_weighted(
    key: torch.Tensor,
    weights: torch.Tensor,
    n_rows: int,
    weights_sum: torch.Tensor | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """[n_rows] categorical draws proportional to non-negative ``weights``
    by inverse CDF: one uniform per row (from row ``row_offset`` of a
    scalar key's draw). All-zero rows return the last index; a
    caller-supplied ``weights_sum`` above cdf[-1] by rounding may clamp a
    u near 1 to the last column (the documented CDF-boundary fringe of the
    JAX package)."""
    u = uniform(key, (n_rows,), row_offset=row_offset)
    return pick_from_uniform(u, weights, weights_sum)
