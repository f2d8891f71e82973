"""One module per metric, found by the metric's name in ``BENCHMARK.json``.

Each holds ``UNIT``, ``BETTER`` (and, for a per-layer metric, ``MOVES``:
the end-to-end metric it should move) and ``read(window)``, which takes the
number from a :class:`benchmark.harness.Window` (launch spans on the host
clock, the harness's own spans, the traced sub-window of each chip) and
returns None where the window holds nothing to read.
"""
