"""``device_idle_share`` in the cells that report ``paths_per_s.device_bound``."""

from benchmark.metrics.device_idle_share import read  # noqa: F401

UNIT, BETTER, MOVES = "share", "lower", "paths_per_s.device_bound"
