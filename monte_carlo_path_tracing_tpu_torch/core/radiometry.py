"""Radiance helpers and the reference's gamma tone map.

Counterpart of ``monte_carlo_path_tracing_tpu/core/radiometry.py``.
"""

from __future__ import annotations

import torch

#: Reference tone-map constants (main.cpp:583): maxRadiance=380, gamma=0.25.
DEFAULT_MAX_RADIANCE = 380.0
DEFAULT_GAMMA = 0.25


def radiance_sum(rad: torch.Tensor) -> torch.Tensor:
    """R+G+B, the light-importance scalar (RadianceRGB.cpp:70-73)."""
    return rad[..., 0] + rad[..., 1] + rad[..., 2]


def tone_map(
    rad: torch.Tensor,
    max_radiance: float = DEFAULT_MAX_RADIANCE,
    gamma: float = DEFAULT_GAMMA,
) -> torch.Tensor:
    """clamp(floor((R/maxR)^gamma * 255 + 0.5), 0, 255) as uint8
    (RadianceRGB.cpp:51-67)."""
    x = torch.clamp(rad, min=0.0) / max_radiance
    x = torch.pow(x, gamma)
    q = torch.floor(x * 255.0 + 0.5)
    return torch.clamp(q, 0.0, 255.0).to(torch.uint8)


def parse_radiance(text: str, device="cuda") -> torch.Tensor:
    """Parse an ``"r,g,b"`` radiance string (RadianceRGB.cpp:17-27) into an
    f32 [3] tensor on ``device``."""
    parts = [float(p) for p in text.split(",")]
    if len(parts) != 3:
        raise ValueError(f"radiance string must be 'r,g,b', got {text!r}")
    return torch.tensor(parts, dtype=torch.float32, device=device)
