"""A run of each cell at a tiny size on the CPU: the result line's keys,
the refusal without a card, and the check against planted faults."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

SEED = 2 ** 40 + 12345   # more than 32 bits, as the driver's seeds are


@pytest.fixture(scope="module")
def results():
    return {}


@pytest.mark.parametrize("name", ["x2_sample_b192", "x2_train_b32"])
def test_the_result_line_has_the_contracts_keys(name):
    res = run.run_cell(tiny.cell(name), SEED, 0.5, False, device="cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert {m["name"] for m in tiny.cell(name).end_to_end} == set(res["metrics"])
    for check in res["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(res)


def test_a_run_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "x2_sample_b192", "--seed", str(SEED),
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,fault", [
    ("x2_sample_b192", "unchanged"), ("x2_sample_b192", "half_batch"),
    ("x2_sample_b192", "altered"), ("x2_train_b32", "unchanged"),
    ("x2_train_b32", "half_batch")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = run.run_cell(tiny.cell(name), SEED, 0.5, False, device="cpu",
                       fault=fault)
    assert res["correct"] is False and res["failed"] >= 1
