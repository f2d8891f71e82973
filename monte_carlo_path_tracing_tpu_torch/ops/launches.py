"""The port's kernels by name, with their launch counters.

Each kernel's wrapper adds one to its ``launches`` where it launches the
kernel and nowhere else. A captured CUDA graph launches its kernels on
every replay without running the wrappers, so
``integrator/graph.CapturedStep`` records what one captured iteration
launched and adds that for each replay (:func:`add`).
"""

from __future__ import annotations

from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, intersect_cuda, rng_cuda

#: Name -> the wrapper whose ``launches`` counts the kernel's launches.
KERNELS = {
    "K1 nearest_hit": intersect_cuda.nearest_hit,
    "K2 occluded": intersect_cuda.occluded,
    "K3 arvo_select": arvo_cuda.arvo_select,
    "K4 nearest_hit_culled": intersect_cuda.nearest_hit_culled,
    "K5 occluded_culled": intersect_cuda.occluded_culled,
    "K6 threefry": rng_cuda.threefry,
}


def counts() -> dict[str, int]:
    """Every kernel's launches so far."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def restore(values: dict[str, int]) -> None:
    """Set the counters to ``values`` (as :func:`counts` returned them)."""
    for name, fn in KERNELS.items():
        fn.launches = values[name]


def reset() -> None:
    restore(dict.fromkeys(KERNELS, 0))


def add(delta: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters."""
    for name, fn in KERNELS.items():
        fn.launches += times * delta[name]
