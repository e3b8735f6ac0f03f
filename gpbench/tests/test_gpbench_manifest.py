"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file that the harness finds by it."""
import json
import os
import re

import pytest

from gpbench.core import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

M = mf.load()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert not p.rstrip("/").endswith("_torch")
    assert any(w.startswith(M["paths"][0]) for w in M["command"][1:])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_texts():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), kind
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for c in M["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_the_contract_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    cells = {w["name"] for w in M["workloads"]}
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}
    for cell in cells:
        e2e = {m["name"] for m in mf.metrics_for(M, "end_to_end", cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = mf.metrics_for(M, "per_layer", cell)
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_configs_and_cells_are_found_by_name():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for c in M["configs"]:
        assert c["file"] == f"gpbench/configs/{c['name']}.json"
        cfg = mf.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in M["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        loop = mf.loop(mf.traffic(w["traffic"])["loop"])
        assert all(hasattr(loop, f) for f in ("setup", "window", "e2e", "record"))
        assert mf.limits(w["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_each_metric_has_a_reader_that_agrees_with_the_manifest(metric):
    entry = next(m for m in M["per_layer"] if m["name"] == metric)
    reader = mf.metric_reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert reader.read({"probes": _EmptyProbes(), "trace": None, "state": {}}) is None


class _EmptyProbes:
    span_seconds: dict = {}
    counters: dict = {}
    captures: dict = {}


def test_layers_are_named_in_perf_md():
    with open(os.path.join(mf.ROOT, "PERF.md")) as fh:
        perf = fh.read()
    for layer in {m["layer"] for m in M["per_layer"]}:
        assert f"| {layer} |" in perf


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
