"""Discovery by name, the measured window's record, and the result line.

``BENCHMARK.json`` names each cell's configuration (its ``file``) and its
traffic mix (``traffic/<mix>.json`` beside this module), and every metric
by the module ``metrics/<name>.py``. A mix names its launcher
(``launchers/<launcher>.py``), and a configuration's ``check`` block the
kind of its ``correct`` check (``checks/<kind>.py``; ``image`` where it
names none). :func:`resolve` finds a workload's configuration, mix and
metrics, :func:`check_module` its check kind and :func:`metric_module` a
metric; nothing here names a configuration, mix, launcher, check kind or
metric, so a later change adds one with files and an entry alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level module names that no process of a run may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "monte_carlo_path_tracing_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file, as loaded
    mix: dict               # the traffic mix's file, as loaded
    end_to_end: list        # this cell's BENCHMARK.json metric entries
    per_layer: list
    root: str = ROOT        # the checkout whose files the cell was resolved from


@dataclasses.dataclass
class Window:
    """What a run measured: the window's start and its whole launches
    (start, end, paths) on the host clock, set-up, the harness's own spans
    and, in a traced run, each chip's traced sub-window."""

    start: float
    launches: list
    setup_s: float
    setup_parts: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    traces: list = dataclasses.field(default_factory=list)


def _in_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(w["name"], int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if _in_cell(m, workload)],
                [m for m in bench["per_layer"] if _in_cell(m, workload)], root)


def _load(folder: str, name: str, root: str):
    """``<root>/benchmark/<folder>/<name>.py``, loaded from its path."""
    path = os.path.join(root, "benchmark", folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no module {name!r} in benchmark/{folder}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: str = ROOT):
    """``<root>/benchmark/metrics/<name>.py``, loaded."""
    return _load("metrics", name, root)


def check_kind(config: dict) -> str:
    """The kind of ``correct`` check a configuration names (``check.kind``),
    ``image`` where it names none."""
    return config.get("check", {}).get("kind", "image")


def check_module(kind: str, root: str = ROOT):
    """``<root>/benchmark/checks/<kind>.py``, loaded: its ``judge`` decides
    ``correct`` and its ``control`` gives the control's readings."""
    return _load("checks", kind, root)


def read_metrics(entries: list, window: Window, root: str = ROOT) -> dict:
    """name -> {"value", "unit"} of the entries whose reader finds
    something; a module's unit, direction and ``moves`` must be its
    entry's."""
    out = {}
    for m in entries:
        mod = metric_module(m["name"], root)
        declared = (mod.UNIT, mod.BETTER, getattr(mod, "MOVES", m.get("moves")))
        if declared != (m["unit"], m["better"], m.get("moves")):
            raise ValueError(f"metric {m['name']}: module says {declared}, BENCHMARK.json "
                             f"{(m['unit'], m['better'], m.get('moves'))}")
        v = mod.read(window)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The run's last line of stdout; ``checks`` (each number compared
    beside its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
