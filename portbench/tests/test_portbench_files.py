"""Every file of the benchmark loads, and ``BENCHMARK.json`` keeps its
format's names, units and shapes."""

import json
import re

import pytest

from conftest import ROOT

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_its_metrics():
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
        e2e, layer = harness.cell_metrics(BENCH, cell["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer, cell["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e_names
        assert m["layer"] and "\n" not in m["layer"]


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=lambda e: e["name"])
def test_workload_files_load(entry):
    wl = harness.load_json(harness.HERE / "workloads"
                           / f"{entry['name']}.json")
    assert (wl["name"], wl["config"], wl["traffic"], wl["chips"],
            wl["why"]) == (entry["name"], entry["config"],
                           entry["traffic"], entry["chips"], entry["why"])
    assert (harness.HERE / "traffic" / f"{wl['traffic']}.py").exists()
    assert hasattr(harness.traffic_module(wl["traffic"]), "Cell")
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files_load(entry):
    from portbench.traffic.train import make_options

    path = ROOT / entry["file"]
    assert path.relative_to(harness.HERE)
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert all(NAME.match(k) for k in entry["reduced"])
    assert make_options(cfg["options"]).batch_size == cfg["options"][
        "batch_size"]


def test_every_per_layer_family_has_a_reader():
    for m in BENCH["per_layer"]:
        family = m["name"].split(".")[0]
        mod = harness.load_module(harness.HERE / "metrics" / f"{family}.py",
                                  f"t_{family}")
        assert callable(mod.read)


def test_object_time_reads_seconds_an_object():
    mod = harness.load_module(harness.HERE / "metrics" / "object_time_s.py",
                              "t_object_time_s")
    assert mod.read(None, {"units": 4, "seconds": 30.0, "spans": {}}) == 7.5
    assert mod.read(None, {"units": 0, "seconds": 30.0, "spans": {}}) is None
