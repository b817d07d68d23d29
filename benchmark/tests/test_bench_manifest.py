"""BENCHMARK.json against the contract's shapes, and every name it gives
against the files the harness finds by it."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def b():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(b):
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(b):
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names), kind
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def _cells_of(m, b):
    return m.get("workloads", [w["name"] for w in b["workloads"]])


def test_every_cell_reports_setup_another_metric_and_a_layer(b):
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if w["name"] in _cells_of(m, b)]
        assert len(mine) >= 2
        assert any(w["name"] in _cells_of(m, b) for m in b["per_layer"])


def test_each_layer_metric_moves_a_metric_its_cells_report(b):
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in _cells_of(m, b):
            assert cell in _cells_of(e2e[m["moves"]], b), (m["name"], cell)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_each_name_has_its_file(b):
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.isfile(os.path.join(BENCH, "drivers", driver + ".py"))
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            limits = json.load(f)["limits"]
        assert limits and all(v > 0 for v in limits.values())
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    configs = {c["name"] for c in b["configs"]}
    assert {w["config"] for w in b["workloads"]} == configs


def test_layers_share_their_names(b):
    by_layer = {}
    for m in b["per_layer"]:
        by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer
