"""Finds everything a cell needs by the names in BENCHMARK.json.

- configs/<config>.json: the configuration as it is run (the program's
  config keys, plus `source`, `reduced` and `assumed`, which it ignores);
- workloads/<traffic>.json: the traffic mix, read by the job it names;
- limits/<workload>.json: the limit of each number compared for
  `correct` in that cell;
- metrics/<family>.py: the reader of the per-layer metrics named
  <family> or <family>.<anything> (the suffix names the end-to-end
  metric the reading moves), `read(run)`, which returns a number or None
  when it finds nothing to read.

A later cell, configuration or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
META_KEYS = ("source", "reduced", "assumed")


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits
    and metrics."""

    def __init__(self, name: str, chips: int, config: dict, traffic: dict,
                 limits: Dict[str, float], end_to_end: List[dict],
                 per_layer: List[dict]):
        self.name, self.chips = name, chips
        self.config = {k: v for k, v in config.items() if k not in META_KEYS}
        self.traffic, self.limits = traffic, limits
        self.end_to_end, self.per_layer = end_to_end, per_layer


def load(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `name` of BENCHMARK.json, its files found by name."""
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file.name}: "
                       f"{sorted(cells)}")
    entry = cells[name]
    read = lambda *parts: json.loads(HERE.joinpath(*parts).read_text())
    return Cell(name, int(entry["chips"]),
                read("configs", f"{entry['config']}.json"),
                read("workloads", f"{entry['traffic']}.json"),
                read("limits", f"{name}.json"),
                [m for m in bench["end_to_end"] if _in(m, name)],
                [m for m in bench["per_layer"] if _in(m, name)])


def _in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(metric: str) -> Path:
    """metrics/<the metric's name up to its first dot>.py."""
    return HERE / "metrics" / f"{metric.split('.')[0]}.py"


def load_reader(metric: str) -> Callable:
    """The read function of the metric's reader file."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
