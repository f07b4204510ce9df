"""BENCHMARK.json against the harness: every configuration, cell and
per-layer metric is found by its name, and the names keep to the
contract's characters."""

import json
import re

import pytest

from uhdrbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_found_by_name(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec, cfg = harness.load_cell(cell)
    assert spec["config"] == w["config"] == cfg["name"]
    assert spec["why"] == w["why"]
    assert spec["op"] in ("encode_api0", "encode_api1", "decode")
    assert set(spec["limits"]) >= ({"out_gap", "out_diff_share"}
                                   if spec["op"] == "decode" else
                                   {"base_diff_share", "map_gap",
                                    "meta_gap"})
    e2e, per_layer = harness.benchmark_entries(cell)
    assert {m["name"] for m in e2e} == {"mpps", "p95_ms", "setup_s"}
    assert per_layer


@pytest.mark.parametrize("cell", sorted(
    p.stem for p in (harness.HERE / "workloads").glob("*.json")))
def test_every_workload_file_loads(cell):
    """Cells kept as files for a later BENCHMARK.json entry load too."""
    spec, cfg = harness.load_cell(cell)
    assert cell == f"{cfg['name']}.{cell.split('.', 1)[1]}"
    assert spec["op"] in ("encode_api0", "encode_api1", "decode")
    assert spec["limits"] and len(spec["why"]) <= 200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(cfg):
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert cfg["file"].startswith("uhdrbench/configs/")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    read = harness.metric_reader(metric["name"])
    assert callable(read)
    assert metric["moves"] == "mpps"
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric["workloads"]) <= cells


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (harness.HERE / "metrics").glob("*.py")))
def test_every_metric_file_has_a_reader(name):
    assert callable(harness.metric_reader(name))
    assert NAME.match(name)


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert BENCH["command"][:3] == ["python3", "-m", "uhdrbench.run"]
    assert BENCH["paths"] == ["uhdrbench"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
