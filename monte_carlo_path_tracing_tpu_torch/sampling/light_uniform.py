"""Light-sample record shared by the light samplers.

Counterpart of ``monte_carlo_path_tracing_tpu/sampling/light_uniform.py``.
Only the :class:`LightSample` record is ported so far; uniform area
sampling itself is ROADMAP queue 1, item 16 ("split and uniform sampling
in regen").
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LightSample:
    """sampledLightPoint (Mylight.h:67-97). ``pdf`` is a solid-angle density
    for the spherical sampler (an area density for the uniform one)."""

    coord: torch.Tensor      # [N,3]
    light_idx: torch.Tensor  # [N] index into scene.light_tri_ids
    tri_id: torch.Tensor     # [N] global triangle id
    emission: torch.Tensor   # [N,3]
    pdf: torch.Tensor        # [N]
    valid: torch.Tensor      # [N] bool (False => dummy sample, contributes 0)
    nl: torch.Tensor         # [N,3] light geometric normal (vote-oriented)
