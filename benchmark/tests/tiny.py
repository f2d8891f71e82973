"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
benchmark's own tests: the same files, with the image, the job, the lanes
and the check's pixels made small."""

from __future__ import annotations

import copy
import json
import os

from benchmark import harness

#: Cells whose configuration and mix are in the benchmark's folder but that
#: BENCHMARK.json does not list yet: name -> (configuration file, mix).
UNLISTED = {"veach-2048-mis-sharded4": ("benchmark/configs/veach-mis-2048-4chip.json",
                                        "sharded")}


def _resolve(workload: str) -> harness.Cell:
    if workload not in UNLISTED:
        return harness.resolve(workload)
    conf, mix = UNLISTED[workload]
    with open(os.path.join(harness.ROOT, conf)) as f:
        config = json.load(f)
    with open(os.path.join(harness.ROOT, "benchmark", "traffic", mix + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        e2e = [m for m in json.load(f)["end_to_end"] if m["name"] in ("paths_per_s", "setup_s")]
    return harness.Cell(workload, int(config["chips"]), config, traffic, e2e, [])


def cell(workload: str, size: int = 16, spp: int = 6, pixels=None, chips=None,
         **mix) -> harness.Cell:
    """The cell with a ``size`` x ``size`` image and a job of ``spp``; the
    check takes every pixel unless ``pixels`` says otherwise."""
    c = copy.deepcopy(_resolve(workload))
    c.config.update(width=size, height=size, spp=spp, lanes=256)
    c.config["check"]["pixels"] = pixels or size * size
    c.mix.update(trace_skip=1, trace_launches=1)
    if c.mix.get("launch_spp") is None:
        c.mix["launch_spp"] = 1
    c.mix.update(mix)
    if chips is not None:
        c.chips = chips
    return c
