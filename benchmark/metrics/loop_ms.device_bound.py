"""``loop_ms`` in the cells that report ``paths_per_s.device_bound``."""

from benchmark.metrics.loop_ms import read  # noqa: F401

UNIT, BETTER, MOVES = "ms", "lower", "paths_per_s.device_bound"
