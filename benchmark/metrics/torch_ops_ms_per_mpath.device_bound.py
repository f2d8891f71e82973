"""``torch_ops_ms_per_mpath`` in the cells that report ``paths_per_s.device_bound``."""

from benchmark.metrics.torch_ops_ms_per_mpath import read  # noqa: F401

UNIT, BETTER, MOVES = "ms/Mpath", "lower", "paths_per_s.device_bound"
