"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, driver and per-layer reader found by name."""
from __future__ import annotations

import json
import re

import pytest

import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cudabench/run.py"]
    assert BENCH["paths"] == ["cudabench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lengths():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key in ("end_to_end", "per_layer"), e["name"]))
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200, (e["name"], text)
                    assert "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metrics = [n for is_metric, n in names if is_metric]
    assert len(metrics) == len(set(metrics))
    assert len(CELLS) == len(set(CELLS))


def test_configs_are_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"cudabench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        body = harness.load_json("configs", c["name"])
        assert body["source"] == c["source"] and len(c["source"]) <= 200
        assert body["reduced"] == c["reduced"] == []


def test_end_to_end_bounds_and_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_per_layer_moves_a_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(name, BENCH)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert name == f"{entry['config']}.{entry['traffic']}"
    assert cell.chips == entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200
    driver = harness.load_module("drivers", cell.traffic["driver"])
    for fn in ("setup", "window", "end_to_end", "counts", "check"):
        assert callable(getattr(driver, fn))
    reported = {m["name"] for m in cell.end_to_end}
    assert reported == set(driver.END_TO_END) | {"setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert cell.limits and all(v is not None and v > 0
                               for v in cell.limits.values())


def test_every_file_is_named_in_benchmark_json():
    """No orphan: each configuration, cell, mix and reader file under
    cudabench/ is one that BENCHMARK.json names."""
    named = {
        "configs": {c["name"] for c in BENCH["configs"]},
        "workloads": set(CELLS),
        "traffic": {w["traffic"] for w in BENCH["workloads"]},
        "metrics": {m["name"] for m in BENCH["per_layer"]},
    }
    for kind, names in named.items():
        suffix = ".py" if kind == "metrics" else ".json"
        found = {p.name[:-len(suffix)]
                 for p in (harness.HERE / kind).glob(f"*{suffix}")}
        assert found == names, kind
