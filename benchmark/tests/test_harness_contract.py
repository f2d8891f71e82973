"""BENCHMARK.json against the static rules of the benchmark's contract."""

import json
import os
import re

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_command_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                              for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = _bench()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    b = _bench()
    assert 1 <= len(b["configs"]) <= 24
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"])) and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in body for k in c["reduced"])
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]


def test_workloads():
    b = _bench()
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])


def test_metrics():
    b = _bench()
    e2e, pl = b["end_to_end"], b["per_layer"]
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    assert any(m["name"] == "setup_s" for m in e2e)
    cells = {w["name"] for w in b["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        layers.setdefault(m["layer"], m["layer"])
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for w in m.get("workloads", cells):
            assert w in cells and w in moved.get("workloads", cells)
    for m in e2e + pl:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        assert sum(w in m.get("workloads", cells) for m in e2e) >= 2
        assert any(w in m.get("workloads", cells) for m in pl)
