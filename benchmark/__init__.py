"""The benchmark of the PyTorch/CUDA port (``monte_carlo_path_tracing_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Configurations (``configs/*.json``), traffic mixes (``traffic/*.json``)
and metrics (``metrics/*.py``) are found by the names ``BENCHMARK.json``
gives them, launchers (``launchers/*.py``) by the name a mix gives, and
the kind of ``correct`` check (``checks/*.py``) by the name a
configuration's ``check`` block gives, ``image`` where it gives none;
``reference/`` is the plain path tracer that the ``image`` kind compares
with. Nothing here imports JAX or the JAX package.
"""
