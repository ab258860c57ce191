"""BENCHMARK.json against the files the harness finds by name."""
from __future__ import annotations

import json

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_workload_resolves_to_its_files(name):
    cell = spec.load(name)
    assert cell.traffic["job"] in ("sample", "train")
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.traffic["rate_metric"] in e2e
    assert cell.per_layer
    for m in cell.per_layer:
        assert spec.reader_path(m["name"]).is_file()
        assert callable(spec.load_reader(m["name"]))


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]


def test_each_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]
