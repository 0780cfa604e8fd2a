"""BENCHMARK.json against the contract it is written to, and every file
the harness finds by name present."""

import json
import re

import pytest

from standin import REPO
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["portbench"]
    assert len(bench["command"]) <= 32
    n = 24
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200


def test_names_and_units(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    for cfg in bench["configs"]:
        assert all(NAME.match(k) for k in cfg["reduced"])
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert len(names) == len(set(names))


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def _reports(bench, metric, cell):
    return cell["name"] in metric.get("workloads", [cell["name"]])


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for cell in bench["workloads"]:
        mine = [m["name"] for m in bench["end_to_end"]
                if _reports(bench, m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(bench, m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in bench["workloads"]:
            if _reports(bench, m, cell):
                assert _reports(bench, moved, cell), (m["name"], cell["name"])


def test_every_configuration_has_a_cell(bench):
    used = {c["config"] for c in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_files_found_by_name(bench):
    pb = REPO / "portbench"
    for cfg in bench["configs"]:
        data = json.loads((REPO / cfg["file"]).read_text())
        assert cfg["file"].startswith("portbench/")
        assert data["reduced"] == cfg["reduced"]
        assert data["peak_flops"] > 0 and data["control_precision"]
        harness.reference_parts(REPO, data)
    for cell in bench["workloads"]:
        traffic = json.loads((pb / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
        assert (pb / "kinds" / f"{traffic['kind']}.py").is_file()
        limits = json.loads((pb / "limits" / f"{cell['name']}.json")
                            .read_text())
        assert limits and all(v > 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert callable(harness.find_reader(REPO, m["name"]))
        layers = {x["layer"] for x in bench["per_layer"]}
        assert all("\n" not in x and len(x) <= 200 for x in layers)
