"""The port's kernels by name, with their launch counters.

Each kernel's wrapper adds one to its ``launches`` where it launches the
kernel and nowhere else; K3's also adds the picks it made to its
``picks``. A captured CUDA graph launches its kernels on every replay
without running the wrappers, so ``integrator/graph.CapturedStep`` records
what one captured iteration counted and adds that for each replay
(:func:`add`).
"""

from __future__ import annotations

from monte_carlo_path_tracing_tpu_torch.ops import arvo_cuda, intersect_cuda, rng_cuda, vertex_cuda

#: Name -> the wrapper whose ``launches`` counts the kernel's launches.
KERNELS = {
    "K1 nearest_hit": intersect_cuda.nearest_hit,
    "K2 occluded": intersect_cuda.occluded,
    "K3 arvo_select": arvo_cuda.arvo_select,
    "K4 nearest_hit_culled": intersect_cuda.nearest_hit_culled,
    "K5 occluded_culled": intersect_cuda.occluded_culled,
    "K6 threefry": rng_cuda.threefry,
    "vertex emit_rr": vertex_cuda.emit_rr,
    "vertex light_brdf": vertex_cuda.light_brdf,
    "vertex nee_add": vertex_cuda.nee_add,
}

#: Name -> (wrapper, attribute) of every counter: the kernels' launches,
#: then K3's points times rounds (a prepass chunk's one launch picks
#: spp_cap lights a pixel).
COUNTERS = {**{name: (fn, "launches") for name, fn in KERNELS.items()},
            "K3 arvo_select picks": (arvo_cuda.arvo_select, "picks")}


def counts() -> dict[str, int]:
    """Every counter so far."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def restore(values: dict[str, int]) -> None:
    """Set the counters to ``values`` (as :func:`counts` returned them)."""
    for name, (fn, attr) in COUNTERS.items():
        setattr(fn, attr, values[name])


def reset() -> None:
    restore(dict.fromkeys(COUNTERS, 0))


def add(delta: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters."""
    for name, (fn, attr) in COUNTERS.items():
        setattr(fn, attr, getattr(fn, attr) + times * delta[name])
