"""The plain reference agrees with itself, and its control (the next
precision below bfloat16) is not correct by the cells' limits."""
from __future__ import annotations

import pytest
import torch

from benchmark.control import CONTROL
from benchmark.harness import weights
from benchmark.harness.sample_job import SampleJob
from benchmark.harness.train_job import TrainJob
from benchmark.reference import compare
from benchmark.reference.diffusion import Reference, train_readings
from benchmark.tests import tiny


def _ref(cell, rows, prec="f32"):
    w = weights.draw(cell.config, 7, "cpu")
    return Reference(cell.config, w, "cpu", prec=prec, rows=rows)


def test_blocks_of_rows_give_the_whole_batchs_step():
    cell = tiny.cell("x2_sample_b192")
    z = torch.randn(4, 16, 16, 8, generator=torch.Generator().manual_seed(1))
    noise = torch.randn_like(z)
    t = cell.config["T"] // 2
    whole = _ref(cell, rows=4).p_sample(z, t, noise)
    blocks = _ref(cell, rows=1).p_sample(z, t, noise)
    for a, b in zip(whole, blocks):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5, atol=1e-5)


def test_the_training_readings_repeat_and_agree_across_blocks():
    cell = tiny.cell("x2_train_b32")
    job = TrainJob(cell.config, cell.traffic, 7, "cpu")
    job.setup()   # the program's dropout masks
    assert job.masks and cell.config["unet_dropout"] > 0
    feeds = lambda: job._feeds(2)
    a = train_readings(_ref(cell, rows=4), feeds(), cell.config["lr"])
    b = train_readings(_ref(cell, rows=1), feeds(), cell.config["lr"])
    gaps = compare.train_gaps(a, b)
    assert all(v < 1e-4 for v in gaps.values()), gaps


@pytest.mark.parametrize("name", ["x2_sample_b192", "x2_train_b32",
                                  "x2int8_sample_b192"])
def test_the_control_is_not_correct(name):
    cell = tiny.int8_cell() if "int8" in name else tiny.cell(name)
    job_cls = SampleJob if cell.traffic["job"] == "sample" else TrainJob
    job = job_cls(cell.config, cell.traffic, 3, "cpu")
    job.setup()
    job.window(0.0, False)
    job.release()
    prec = CONTROL[cell.config.get("conv_quant") or cell.config["compute_dtype"]]
    numbers = job.check(precs=(prec,))
    assert compare.verdict(numbers["program"], cell.limits)["correct"]
    assert not compare.verdict(numbers[prec], cell.limits)["correct"]
