"""Render configuration.

Counterpart of ``monte_carlo_path_tracing_tpu/utils/config.py``: the same
frozen dataclass with the same fields and defaults, so a configuration
reads the same in both packages. Left out are the knobs that only select
TPU code: ``use_pallas``, ``dot_mode`` (the port's kernels are exact f32)
and ``fused_arvo`` (the port picks its Arvo kernel by tensor device).
Every other field runs. The one value the port rejects is
``ray_sort_every > 1`` (``integrator/regen.py``: not ported, by decision),
named with its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Estimators (reference main.cpp:269-494)
EST_BRDF = "brdf"      # shade_with_brdf  (main.cpp:348-399)
EST_SPLIT = "split"    # shade            (main.cpp:269-344)
EST_MIS = "mis"        # shade_with_mis   (main.cpp:402-494) — flagship
EST_SHOOT = "shoot"    # legacy shoot     (main.cpp:96-265, dead code in ref)
ESTIMATORS = (EST_BRDF, EST_SPLIT, EST_MIS, EST_SHOOT)

# Light samplers (reference Mylight.cpp:102-160 / 163-493)
LS_UNIFORM_AREA = "uniform_area"
LS_SPHERICAL = "spherical_triangle"
LIGHT_SAMPLERS = (LS_UNIFORM_AREA, LS_SPHERICAL)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image
    width: int = 1280
    height: int = 720           # reference main.cpp:539 (1280x720)
    spp: int = 10               # reference main.cpp:567

    # Estimator
    estimator: str = EST_MIS
    light_sampler: str = LS_SPHERICAL
    rr_prob: float = 0.6        # survival probability P_RR (main.cpp:321,375,429)
    max_depth: int = 32         # bound of the fixed-depth wavefront

    # Tone map (main.cpp:583)
    max_radiance: float = 380.0
    gamma: float = 0.25

    # RNG
    seed: int = 0

    # Sub-pixel jitter for antialiasing (the reference has none).
    pixel_jitter: bool = False

    # Quirk-compat flags (SURVEY.md §7 quirks registry).
    fov_bug_compat: bool = False     # Q2: degrees-as-radians half-fov
    measure_bug_compat: bool = False  # Q3: area-form G with solid-angle pdf in `shade`
    branch_pdf_compat: bool = False   # Q4: divide by branch pdf, not mixture pdf
    ref_mis_weights: bool = False     # Q11: reference's nearest-light-denominator MIS
    mis_blocker_compat: bool = False  # Q11 full parity (blocker-chain queue)

    debug_checks: bool = False

    # Wavefront / performance
    ray_chunk: int = 1 << 16    # rays in flight per fixed-depth batch
    accel: str = "auto"         # "auto" / "all_pairs" / "grid"
    grid_n0: int = 100_000      # grid target cell count (main.cpp:520)
    ray_sort: bool = False      # regen lane sort (pure permutation)
    ray_sort_every: int = 1
    # Primary-hit cache of the regen renderer: None = auto (on when
    # eligible), True forces it, False forces the uncached loop.
    primary_cache: Optional[bool] = None

    # Distribution
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ("tiles",)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.estimator not in ESTIMATORS:
            raise ValueError(f"estimator must be one of {ESTIMATORS}, got {self.estimator}")
        if self.light_sampler not in LIGHT_SAMPLERS:
            raise ValueError(
                f"light_sampler must be one of {LIGHT_SAMPLERS}, got {self.light_sampler}"
            )
        if not (0.0 < self.rr_prob < 1.0):
            raise ValueError("rr_prob must be in (0, 1)")
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.accel not in ("auto", "all_pairs", "grid"):
            raise ValueError(
                f"accel must be 'auto', 'all_pairs' or 'grid', got {self.accel}"
            )
        if self.mis_blocker_compat and not self.ref_mis_weights:
            raise ValueError(
                "mis_blocker_compat reproduces the reference's full MIS "
                "recursion and requires ref_mis_weights=True"
            )
        if self.ray_sort_every < 1:
            raise ValueError("ray_sort_every must be >= 1")
        if self.primary_cache:
            from monte_carlo_path_tracing_tpu_torch.integrator.regen import (
                primary_cache_eligible,
            )

            if not primary_cache_eligible(self):
                raise ValueError(
                    "primary_cache=True requires estimator in "
                    "('mis','brdf','split'), pixel_jitter=False and "
                    "mis_blocker_compat=False (the depth-0 work must be "
                    "per-pixel deterministic)"
                )
