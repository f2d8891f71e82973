"""Configurations, mixes, launchers, check kinds and metrics are found by
name; a new one is added with files and an entry, and no file that is
there changes."""

import json
import os
import shutil
import sys
import time

import pytest

import benchmark.launchers
from benchmark import harness, run

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves(workload):
    cell = harness.resolve(workload)
    assert cell.config["chips"] == cell.chips
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "launchers",
                                       cell.mix["launcher"] + ".py"))
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "checks",
                                       harness.check_kind(cell.config) + ".py"))
    kind = harness.check_module(harness.check_kind(cell.config))
    assert callable(kind.judge) and callable(kind.control)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m for m in _bench()["end_to_end"] + _bench()["per_layer"]],
                         ids=lambda m: m["name"])
def test_every_metric_module_declares_its_entry(metric):
    mod = harness.metric_module(metric["name"])
    assert (mod.UNIT, mod.BETTER) == (metric["unit"], metric["better"])
    assert getattr(mod, "MOVES", None) == metric.get("moves")
    assert callable(mod.read)


def _tree_digest(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d:              # bytecode that loading a module may write
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_throwaway_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(tmp_path)

    cfg = json.loads((tmp_path / "benchmark/configs/veach-mis-1024.json").read_text())
    cfg.update(width=512, height=512, chips=1)
    (tmp_path / "benchmark/configs/throwaway-512.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/throwaway-mix.json").write_text(
        json.dumps({"launcher": "single", "launch_spp": 2}))
    (tmp_path / "benchmark/metrics/throwaway_launches.py").write_text(
        'UNIT, BETTER, MOVES = "launches", "higher", "paths_per_s"\n\n'
        "def read(window):\n    return len(window.launches)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway-512", "source": "https://example.org/throwaway",
                             "file": "benchmark/configs/throwaway-512.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway-512",
                               "traffic": "throwaway-mix", "chips": 1, "why": "a throwaway"})
    next(m for m in bench["end_to_end"] if m["name"] == "paths_per_s")["workloads"].append(
        "throwaway.cell")
    bench["per_layer"].append({"name": "throwaway_launches", "unit": "launches",
                               "better": "higher", "source": "host_clock", "layer": "a throwaway",
                               "moves": "paths_per_s", "workloads": ["throwaway.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve("throwaway.cell", root=str(tmp_path))
    assert cell.config["width"] == 512 and cell.mix["launch_spp"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "throwaway_launches"
    window = harness.Window(start=0.0, launches=[(0.0, 1.0, 10), (1.0, 2.5, 10)], setup_s=3.0)
    got = harness.read_metrics(cell.per_layer, window, root=str(tmp_path))
    assert got["throwaway_launches"] == {"value": 2.0, "unit": "launches"}
    e2e = harness.read_metrics(cell.end_to_end, window, root=str(tmp_path))
    assert e2e["paths_per_s"]["value"] == pytest.approx(20 / 2.5)

    after = _tree_digest(tmp_path)
    changed = [p for p in before if p != "BENCHMARK.json" and after[p] != before[p]]
    assert changed == []
    assert sorted(set(after) - set(before)) == sorted([
        "benchmark/configs/throwaway-512.json", "benchmark/traffic/throwaway-mix.json",
        "benchmark/metrics/throwaway_launches.py"])


def test_a_throwaway_launcher_is_loaded_by_the_name_its_mix_gives(tmp_path, monkeypatch):
    import benchmark.launchers
    from benchmark import run

    (tmp_path / "throwaway_launcher.py").write_text(
        "def run(cell, seed, seconds, traced, clock, device='cuda'):\n"
        "    return ('throwaway', cell.name, seed, device)\n")
    monkeypatch.setattr(benchmark.launchers, "__path__",
                        list(benchmark.launchers.__path__) + [str(tmp_path)])
    cell = harness.Cell("throwaway.cell", 1, {}, {"launcher": "throwaway_launcher"}, [], [])
    assert run.window_run(cell, 7, 1.0, False, device="cpu") == (
        "throwaway", "throwaway.cell", 7, "cpu")


def test_a_metric_module_that_disagrees_with_its_entry_is_refused():
    entry = dict(_bench()["end_to_end"][0], unit="not-its-unit")
    window = harness.Window(start=0.0, launches=[(0.0, 1.0, 1)], setup_s=1.0)
    with pytest.raises(ValueError):
        harness.read_metrics([entry], window)


THROWAWAY_LAUNCHER = """\
from benchmark.harness import Window
from benchmark.launchers import common


def run(cell, seed, seconds, traced, clock, device="cuda"):
    # Three optimiser-like steps of 4 paths each, and a loss a step for the check.
    clock.mark("steps_s")
    t0 = clock.t_last
    launches = [(t0 + i, t0 + i + 0.5, 4) for i in range(3)]
    window = Window(start=t0, launches=launches, setup_s=clock.total(),
                    setup_parts=dict(clock.parts))
    return common.Measured(window, rays=12, device=common.device_record(device, 1, 0),
                           extra={"loss": [3.0, 2.0, 1.5 + seed % 2]})
"""

THROWAWAY_KIND = """\
def judge(cell, measured, seed, device="cuda", dtype=None):
    loss = measured.extra["loss"]
    numbers = {"loss_rise": max(b - a for a, b in zip(loss, loss[1:]))}
    limits = cell.config["check"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return numbers, checks, {"steps_checked": len(loss)}


def control(cell, seed, n, device="cuda"):
    return {"loss_rise": 1.0}
"""


def test_a_throwaway_check_kind_and_launcher_run_through_measure(tmp_path, monkeypatch):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(tmp_path)

    (tmp_path / "benchmark/configs/throwaway-steps.json").write_text(json.dumps(
        {"chips": 1, "check": {"kind": "throwaway_loss", "limits": {"loss_rise": 0.0}}}))
    (tmp_path / "benchmark/traffic/throwaway-steps.json").write_text(
        json.dumps({"launcher": "throwaway_steps"}))
    (tmp_path / "benchmark/launchers/throwaway_steps.py").write_text(THROWAWAY_LAUNCHER)
    (tmp_path / "benchmark/checks/throwaway_loss.py").write_text(THROWAWAY_KIND)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway-steps", "source": "https://example.org/steps",
                             "file": "benchmark/configs/throwaway-steps.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "throwaway.steps", "config": "throwaway-steps",
                               "traffic": "throwaway-steps", "chips": 1, "why": "a throwaway"})
    next(m for m in bench["end_to_end"] if m["name"] == "paths_per_s")["workloads"].append(
        "throwaway.steps")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    # The launcher is found by name in the copy's launchers/, as a new file there.
    monkeypatch.setattr(benchmark.launchers, "__path__",
                        [str(tmp_path / "benchmark/launchers")]
                        + list(benchmark.launchers.__path__))
    cell = harness.resolve("throwaway.steps", root=str(tmp_path))
    assert cell.root == str(tmp_path)
    got = {}
    try:
        for seed in (2**40, 2**40 + 1):
            line, checks, diag = run.measure(cell, seed, 0.0, False, device="cpu",
                                             t_start=time.perf_counter())
            got[seed] = json.loads(line), checks, diag
    finally:
        sys.modules.pop("benchmark.launchers.throwaway_steps", None)

    ok, checks, diag = got[2**40]
    assert ok["correct"] is True and ok["attempted"] == 3
    assert checks == {"loss_rise": {"value": -0.5, "limit": 0.0}} == ok["checks"]
    assert ok["metrics"]["paths_per_s"]["value"] == pytest.approx(12 / 2.5)
    assert set(ok["metrics"]) == {"paths_per_s", "setup_s"}
    assert diag["steps_checked"] == 3 and diag["launches"] == 3 and diag["paths"] == 12
    assert "spp_checked" not in diag
    bad, checks, _ = got[2**40 + 1]
    assert bad["correct"] is False and checks["loss_rise"]["value"] == 0.5

    after = _tree_digest(tmp_path)
    changed = [p for p in before if p != "BENCHMARK.json" and after[p] != before[p]]
    assert changed == []
    assert sorted(set(after) - set(before)) == sorted([
        "benchmark/configs/throwaway-steps.json", "benchmark/traffic/throwaway-steps.json",
        "benchmark/launchers/throwaway_steps.py", "benchmark/checks/throwaway_loss.py"])
