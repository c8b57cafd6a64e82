"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

import pytest

from gpubench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = run.bench()
HERE = run.HERE


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert list(DOC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert DOC["paths"] == ["gpubench"] and DOC["command"][1] == "gpubench/run.py"
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("gpubench/") and os.path.exists(os.path.join(run.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"]) and w["chips"] == 1
        assert w["config"] in names
        names.append(w["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in DOC["workloads"]}) == len(DOC["workloads"])


def test_metric_entries():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in DOC["workloads"]]
    for m in DOC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:  # each listed cell reports the end-to-end metric the metric moves
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one in every cell
        assert sum(cell in m.get("workloads", cells) for m in DOC["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in DOC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_every_piece_is_found_by_name(cell):
    entry = run.cell_of(DOC, cell)
    with open(os.path.join(HERE, "workloads", f"{cell}.json")) as f:
        wl = json.load(f)
    assert (wl["config"], wl["traffic"]) == (entry["config"], entry["traffic"])
    assert os.path.exists(os.path.join(HERE, "traffic", f"{entry['traffic']}.py"))
    for m in run.metrics_of(DOC, cell, False) + run.metrics_of(DOC, cell, True):
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]
    assert wl["params"]["limits"] and all(v > 0 for v in wl["params"]["limits"].values())


@pytest.mark.parametrize("name", [c["name"] for c in DOC["configs"]])
def test_config_files(name):
    entry = {c["name"]: c for c in DOC["configs"]}[name]
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == name and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert cfg["precision"] == "float32" and cfg["assumed"]
