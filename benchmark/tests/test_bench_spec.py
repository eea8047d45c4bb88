"""BENCHMARK.json and the files it names: keys, names, units, and the links
between metrics, cells and files."""

import json
import re

import pytest

from harness import spec

SPEC = json.loads(spec.SPEC.read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    assert (spec.ROOT / SPEC["command"][1]).is_file()
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(spec.SPEC.read_bytes()) <= 64 * 1024


def test_the_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


ALL_NAMES = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])


@pytest.mark.parametrize("name", sorted(set(ALL_NAMES)))
def test_names_use_only_the_allowed_characters(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in SPEC["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert LINE.match(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    assert set(metric) - {"workloads"} == keys
    assert spec.UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert all(w in CELLS for w in metric.get("workloads", CELLS))
    assert callable(spec.metric_reader(metric["name"]).read)


def test_unique_names_and_setup_metric():
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        names = [g["name"] for g in group]
        assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_load(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["source"].startswith("https://") and LINE.match(config["why"])
    path = spec.ROOT / config["file"]
    assert path.is_file() and config["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    body = spec.load_json(path)
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(config["file"]) == 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    cell = spec.cell(name)
    assert set(cell.entry) == {"name", "config", "traffic", "chips", "why"}
    assert cell.entry["chips"] in (1, 4) and LINE.match(cell.entry["why"])
    assert (spec.BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.own["flops"]
    assert all(f["flop"] > 0 and f["command"] and f["date"] for f in cell.own["flops"].values())
    assert cell.own["limits"] and all(v >= 0 for v in cell.own["limits"].values())


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(name):
    cell = spec.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for name in metric.get("workloads", CELLS):
        assert metric["moves"] in {m["name"] for m in spec.cell(name).end_to_end}, name


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_files_under_paths_are_named_from_name_characters():
    for path in spec.BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(spec.ROOT).as_posix()
            assert PATH.match(rel), rel
