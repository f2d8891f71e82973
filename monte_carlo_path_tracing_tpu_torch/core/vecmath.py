"""Batched 3-vector math on tensors of shape [..., 3].

Counterpart of ``monte_carlo_path_tracing_tpu/core/vecmath.py``. Dots and
cross products are written out term by term, in a fixed order, as separate
elementwise ops: torch then evaluates them with the same IEEE f32
arithmetic on the CPU and on CUDA (no reduction-order or FMA-contraction
differences), which keeps the port's two devices and its kernels' plain
versions in step.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[...,3] x [...,3] -> [...]: ((a0 b0 + a1 b1) + a2 b2)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (reference vec.cpp:67-70)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def det3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Scalar triple product a . (b x c) (reference vec.cpp:84-87)."""
    return dot(a, cross(b, c))


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """a / |a|, or 0 where |a|^2 <= eps (reference vec.cpp:99-103)."""
    sq = dot(a, a)[..., None]
    inv = torch.reciprocal(torch.sqrt(torch.clamp(sq, min=eps)))
    return a * torch.where(sq > eps, inv, torch.zeros_like(inv))


def reflect(wi: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror direction of wi about n: 2(wi.n)n - wi (BRDF.cpp:17-25)."""
    return 2.0 * dot(wi, n)[..., None] * n - wi


def orthonormal_basis(n: torch.Tensor):
    """Branch-free (t, b) so that (t, b, n) is right-handed (Duff et al.)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t, bt


def from_local(w_local, t, b, n):
    """x*t + y*b + z*n."""
    return w_local[..., 0:1] * t + w_local[..., 1:2] * b + w_local[..., 2:3] * n
