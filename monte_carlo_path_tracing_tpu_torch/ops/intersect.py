"""Intersection engine: accel build and device dispatch.

Counterpart of ``monte_carlo_path_tracing_tpu/ops/intersect.py``. The
"accel" is every triangle's packed [10, 4] matrix in Morton order of the
centroids (so consecutive triangles are spatially compact), padded to a
multiple of ``TRI_BLOCK``. :func:`intersect` and :func:`occluded` run the
all-pairs test through ``ops/intersect_cuda.py``: the K1 / K2 kernels for
CUDA tensors, their plain torch versions for CPU tensors.

Not ported yet (ROADMAP queue 2): the culled kernels K4 / K5, with the
per-triangle AABBs of the JAX TriAccel that schedule them, and the uniform
grid.
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_path_tracing_tpu_torch.ops import intersect_cuda
from monte_carlo_path_tracing_tpu_torch.ops.intersect_ref import (  # noqa: F401
    NO_HIT, T_EPS, Hit, pack_tri_matrix, ray_features,
)
from monte_carlo_path_tracing_tpu_torch.scene.types import Scene

#: Padding multiple of the accel's triangle arrays.
TRI_BLOCK = 512

#: Relative margin for shadow-ray occlusion: a hit counts as blocking only
#: below t_max * (1 - margin), keeping the sampled light surface itself out.
OCCLUSION_MARGIN = 1e-3


@dataclasses.dataclass(frozen=True)
class TriAccel:
    W: torch.Tensor        # [Tpad, 10, 4] packed coefficient matrices
    tri_ids: torch.Tensor  # [Tpad] int32 global ids (padding rows: -2)


def _spread10(x: torch.Tensor) -> torch.Tensor:  # 10 bits -> every 3rd bit of 30
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_order(v0, e1, e2) -> torch.Tensor:
    """Stable sort order by the 3x10-bit Morton code of the centroid (a
    stable sort keeps equal codes in id order, as jnp.argsort does)."""
    c = v0 + (e1 + e2) / 3.0
    lo = torch.amin(torch.minimum(v0, torch.minimum(v0 + e1, v0 + e2)), dim=0)
    hi = torch.amax(torch.maximum(v0, torch.maximum(v0 + e1, v0 + e2)), dim=0)
    q = torch.clamp(
        ((c - lo) / torch.clamp(hi - lo, min=1e-20) * 1023.0).to(torch.int32), 0, 1023
    )
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


def _build(v0, e1, e2, ids, block: int) -> TriAccel:
    order = _morton_order(v0, e1, e2)
    v0, e1, e2, ids = v0[order], e1[order], e2[order], ids[order]
    T = v0.shape[0]
    W = pack_tri_matrix(v0, e1, e2)
    pad = (-T) % block
    if pad:
        dev = v0.device
        W = torch.cat([W, torch.zeros((pad, 10, 4), dtype=W.dtype, device=dev)])
        ids = torch.cat([ids, torch.full((pad,), -2, dtype=torch.int32, device=dev)])
    return TriAccel(W=W.contiguous(), tri_ids=ids.contiguous())


def build_accel(scene: Scene, block: int = TRI_BLOCK) -> TriAccel:
    ids = torch.arange(scene.num_tris, dtype=torch.int32, device=scene.device)
    return _build(scene.tri_v0, scene.tri_e1, scene.tri_e2, ids, block)


def _exclude(exclude_id, n, device):
    if exclude_id is None:
        return torch.full((n,), NO_HIT, dtype=torch.int32, device=device)
    return exclude_id.to(torch.int32).contiguous()


def intersect(
    accel: TriAccel,
    ro: torch.Tensor,
    rd: torch.Tensor,
    exclude_id: torch.Tensor | None = None,
    t_eps: float = T_EPS,
) -> Hit:
    """Nearest hit of N rays against the accel's triangles; self-
    intersection avoidance by triangle-id exclusion (quirk Q8)."""
    g = ray_features(ro, rd).contiguous()
    return intersect_cuda.nearest_hit(
        g, accel.W, accel.tri_ids, _exclude(exclude_id, ro.shape[0], ro.device), t_eps
    )


def occluded(
    accel: TriAccel,
    ro: torch.Tensor,
    rd: torch.Tensor,
    t_max: torch.Tensor,
    exclude_id: torch.Tensor | None = None,
    t_eps: float = T_EPS,
) -> torch.Tensor:
    """[N] bool: something blocks the segment ro -> ro + t_max * rd (the
    NEE visibility predicate, with ``OCCLUSION_MARGIN``)."""
    g = ray_features(ro, rd).contiguous()
    scaled = (t_max * (1.0 - OCCLUSION_MARGIN)).to(torch.float32).contiguous()
    return intersect_cuda.occluded(
        g, accel.W, accel.tri_ids, _exclude(exclude_id, ro.shape[0], ro.device),
        scaled, t_eps,
    )
