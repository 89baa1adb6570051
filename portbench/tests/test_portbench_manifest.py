"""The manifest against the benchmark's rules, and every cell's files
found by name. CPU only, no simulation."""
import json
import os
import re

import pytest

from portbench import cells

MAN = cells.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(cells.MANIFEST) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[k]), (e["name"], k)


def test_metrics_and_cells_agree():
    cellnames = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cellnames)) <= cellnames
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cellnames:       # every cell reports a per-layer metric
        assert any(w in m.get("workloads", cellnames) for m in MAN["per_layer"])
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = cells.load_cell(workload)
    entry = {w["name"]: w for w in MAN["workloads"]}[workload]
    conf = {c["name"]: c for c in MAN["configs"]}[entry["config"]]
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    assert set(conf["reduced"]) <= set(cell.config["spec"])
    assert set(cell.limits) >= {"flows_differ", "fct_gap"}
    fields = cell.grid(3_000_000_019)
    assert len({json.dumps(f, sort_keys=True) for f in fields}) == len(fields)
    assert cells.engine_steps(fields[0]) > 0
    for m in cell.metrics:
        assert callable(cells.metric_reader(m["name"]))
    chk = cell.checked(3_000_000_019, len(fields))
    assert chk == sorted(set(chk)) and 0 < len(chk) <= len(fields)
