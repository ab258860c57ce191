"""The per-layer readers on a made-up traced window."""
from __future__ import annotations

import pytest

from benchmark.harness import common, costs, readers
from benchmark.harness import spec
from benchmark.harness.spec import load, load_reader
from benchmark.harness.trace import Traced, category


def _record(kernels, window_s, **kw):
    cell = load("x2_sample_b192")
    rec = common.Record("sample", cell.config, cell.traffic, 192, **kw)
    rec.traced = Traced(kernels, [("aten::conv2d", 0.0, 0.05)], window_s)
    return rec


def test_busy_is_the_union_and_idle_counts_the_whole_window():
    rec = _record([("elementwise_kernel", 0.1, 0.3), ("ctx_mma_kernel", 0.2, 0.4),
                   ("nchwToNhwc", 0.5, 0.6)], 1.0, traced_steps=1,
                  steps=10, seconds=5.0, busy_by_key={0: 0.4},
                  window_keys=[0] * 10)
    assert rec.traced.busy_s == pytest.approx(0.4)
    assert readers.idle_share(rec) == pytest.approx(100 * (1 - 0.4 * 10 / 5.0))
    assert load_reader("elementwise_layout_share.sample")(rec) == pytest.approx(
        100 * (0.2 + 0.1) / 0.4)
    assert readers.launches_per_step(rec) == 3
    gaps = dict(rec.traced.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(0.6)


def test_k1_roofline_reads_only_the_launches_of_the_sites():
    sites = costs.attention_sites(load("x2_sample_b192").config)
    kernels = [("ctx_mma_kernel", 0.0, 0.01), ("out_mma_kernel", 0.01, 0.02)]
    rec = _record(kernels, 0.1, traced_steps=2,
                  traced_launches={"attn_ctx": 2 * len(sites),
                                   "attn_out": 2 * len(sites)})
    value = load_reader("K1_roofline.sample")(rec)
    assert value == pytest.approx(100 * readers.k1_least_s(rec) / 0.02)
    rec.traced_launches["attn_ctx"] += 1
    assert load_reader("K1_roofline.sample")(rec) is None


def test_kernel_names_fall_into_the_copied_categories():
    assert category("convres_bwd_kernel<1>") == "K3 convres_bwd"
    assert category("convres_fwd_kernel") == "K2 convres"
    assert category("void at::native::vectorized_elementwise_kernel") == "elementwise"


def test_marks_split_the_busy_time_by_step_and_idle_follows_each_steps_work():
    traced = Traced([("a", 0.0, 0.2), ("b", 0.15, 0.3), ("c", 0.5, 0.9)],
                    [], 1.0, marks=(0.4, 0.95))
    assert traced.step_busy() == pytest.approx([0.3, 0.4])
    cell = load("x3_train_b512")
    rec = common.Record("train", cell.config, cell.traffic, 512,
                        traced=traced, traced_steps=2, seconds=2.0,
                        busy_by_key={1: 0.3, 0: 0.4}, window_keys=[0, 1, 1])
    assert load_reader("idle_share.bulk_train")(rec) == pytest.approx(
        100 * (1 - 1.0 / 2.0))
    rec.window_keys.append(2)   # a step whose work was not traced
    assert load_reader("idle_share.bulk_train")(rec) is None


def test_every_suffix_of_a_metric_reads_its_familys_file():
    assert spec.reader_path("mfu.train") == spec.reader_path("mfu.sample") \
        == spec.HERE / "metrics" / "mfu.py"
