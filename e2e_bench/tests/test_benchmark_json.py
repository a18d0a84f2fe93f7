"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the metrics each cell reports, and a file for everything named."""

import json
import re

import pytest

from e2e_bench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    allowed = {
        "config": {"name", "source", "file", "reduced", "why"},
        "cell": {"name", "config", "traffic", "chips", "why"},
        "e2e": {"name", "unit", "better", "bound", "source", "workloads"},
        "layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"}}
    kind = ("config" if "file" in entry else "cell" if "traffic" in entry
            else "e2e" if "bound" in entry else "layer")
    assert set(entry) <= allowed[kind]
    assert set(entry) >= allowed[kind] - {"workloads"}
    if kind in ("e2e", "layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in (
            "lower", "higher")
        for cell in entry.get("workloads", []):
            assert cell in CELLS
    if kind == "e2e":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if kind == "layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert _text(entry["layer"])
    if kind == "cell":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and _text(entry["why"])
    if kind == "config":
        assert _text(entry["source"]) and _text(entry["why"])
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) for k in entry["reduced"])


def test_unique_names_and_files():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(BENCH["paths"][0] + "/") and (ROOT / f).is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert 1 <= len(CELLS) <= 24


def _reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_in_the_metric_cells(metric):
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert _reports(moved, cell)


def test_one_layer_name_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files(cell):
    base = ROOT / "e2e_bench"
    mix = json.loads((base / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    assert (base / "entries" / f"{mix['entry']}.py").is_file()
    limits = json.loads((base / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert (ROOT / "e2e_bench" / "metrics" / f"{metric['name']}.py").is_file()


def test_configs_name_their_departures_and_precision():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["departures"] and cfg["assumed"]
        assert cfg["precision"]["dtype"] == "float32"
