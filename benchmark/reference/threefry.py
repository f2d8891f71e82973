"""Threefry-2x32 streams in int64 torch ops, as JAX defines them.

A key is an int64 tensor [..., 2] of two uint32 words. ``fold_in(key, d)``
is threefry2x32(key, (0, d)); a batched key's uniform draw of k values
takes the counts 0..k-1 (JAX's partitionable ``random_bits``), and the
float is the top 23 bits under exponent 0 minus one. The renderer folds one
base key by (spp round, pixel, depth, purpose), so every path owns its
stream and the reference draws what the program draws, number for number.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

#: Purposes folded into a path's depth key.
P_BSDF, P_LIGHT_SELECT, P_RR = 1, 2, 4


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def base_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``: words (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """fold_in broadcast over batched keys and / or [N] data (mod 2**32)."""
    d = data.to(torch.int64) & M32 if torch.is_tensor(data) else int(data) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(key: torch.Tensor, k: int = 1) -> torch.Tensor:
    """[N, k] float32 uniforms in [0, 1), one independent draw per [N, 2] key."""
    count = torch.arange(k, dtype=torch.int64, device=key.device)[None, :]
    y0, y1 = threefry2x32(key[:, 0:1], key[:, 1:2], 0, count)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
