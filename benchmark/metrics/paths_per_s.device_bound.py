"""``paths_per_s`` in the cells whose launches are seconds of device work,
so that the per-launch host time (captures, the allocator) is a small
share of each and the rate holds a tighter bound."""

from benchmark.metrics.paths_per_s import read  # noqa: F401

UNIT, BETTER = "paths/s", "higher"
