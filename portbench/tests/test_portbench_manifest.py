"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, bounds, and the layer metrics' ``moves``."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
CELLS = [w["name"] for w in MAN["workloads"]]


def e2e_cells(metric):
    return set(metric.get("workloads", CELLS))


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= len(MAN["command"]) <= 32 and all(one_line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [x["name"] for x in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_keys_units_and_sources(kind):
    for m in MAN[kind]:
        extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == METRIC_KEYS | extra, m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        allowed = (("host_clock", "device_trace") if kind == "end_to_end" else
                   ("device_trace", "program_span", "program_counter", "host_clock"))
        assert m["source"] in allowed
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_configs_and_cells():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (harness.ROOT / c["file"]).is_file()
        assert one_line(c["why"]) and one_line(c["source"]) and len(c["reduced"]) <= 16
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["assumed"] and body["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"]) and NAME.match(w["traffic"])
        cell = json.loads((harness.BENCH_DIR / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"]
        assert (harness.BENCH_DIR / "drivers" / f"{cell['entry']}.py").is_file()
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_moves_what_its_cells_report(metric):
    """Every cell that reports a layer metric reports the end-to-end metric
    it moves; the metric has its reader."""
    moves = {m["name"]: m for m in MAN["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= e2e_cells(moves)
    assert one_line(metric["layer"])
    assert (harness.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in MAN["end_to_end"] if cell in e2e_cells(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in m["workloads"] for m in MAN["per_layer"]), cell


def test_bounds_and_run_seconds_fit_the_check():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] == 0.25
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
