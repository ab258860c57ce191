"""What the per-layer metrics compute from a run's Record (see
common.Record).  A reader that finds nothing to read returns None, and
the metric is left out of the run's line."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from benchmark.harness import costs

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def idle_share(run) -> Optional[float]:
    """% of the untraced window's time in which the device is idle: one
    less the device's busy time of its steps over the window, each
    step's busy time that of the traced step of the same work (the union
    of the device's spans in the trace; in training, one traced step for
    each pair of recon sizes; in sampling, the checked steps, whose
    copies to the host the trace counts, apart from the plain ones; see
    the jobs).  Read in the trace's own window, the idle share would
    count the profiler's cost to the host's issue, several times the
    true idle on a launch-bound step."""
    keys = run.window_keys
    if run.traced is None or not keys or run.seconds <= 0 \
            or any(k not in run.busy_by_key for k in keys):
        return None
    busy = sum(run.busy_by_key[k] for k in keys)
    return 100.0 * (1.0 - busy / run.seconds)


def mfu(run) -> Optional[float]:
    """Model FLOPs of the untraced rest of the window over its time (the
    sampler's with its decode pro rata), as a % of the bf16 peak."""
    if not run.steps or run.seconds <= 0 or not run.flops:
        return None
    seconds = run.seconds
    if run.decode_s is not None:
        seconds += run.steps / run.config["T"] * run.decode_s
    return 100.0 * run.flops / seconds / costs.PEAK_BF16


def share(run, categories: Iterable[str]) -> Optional[float]:
    """% of the device's busy time in kernels of these categories."""
    if run.traced is None or run.traced.busy_s <= 0:
        return None
    by = run.traced.by_category()
    return 100.0 * sum(by.get(c, 0.0) for c in categories) / run.traced.busy_s


def launches_per_step(run) -> Optional[float]:
    if run.traced is None or not run.traced_steps:
        return None
    return len(run.traced.kernels) / run.traced_steps


def roofline(run, categories: Iterable[str], least_s: float) -> Optional[float]:
    """The least time of the launches over their device time, in %."""
    if run.traced is None:
        return None
    spent = sum(run.traced.by_category().get(c, 0.0) for c in categories)
    return 100.0 * least_s / spent if spent > 0 else None


def k1_least_s(run) -> Optional[float]:
    """K1a + K1b's least time over the traced sampling steps, or None
    when the launches counted are not those of the sites."""
    sites = costs.attention_sites(run.config)
    n = len(sites) * run.traced_steps
    got = run.traced_launches
    if run.kind != "sample" or not n or got.get("attn_ctx") != n \
            or got.get("attn_out") != n:
        return None
    item = ITEMSIZE[run.config["compute_dtype"]]
    one = sum(costs.least_s(c["attn_ctx"]) + costs.least_s(c["attn_out"])
              for c in (costs.attention(run.batch, tokens, ch, item)
                        for tokens, ch in sites))
    return run.traced_steps * one


def q1_least_s(run) -> Optional[float]:
    """Q1's least time over the traced sampling steps (s8 peak), or None
    when the launches counted are not those of the int8 mode's convs."""
    if run.kind != "sample" or run.config.get("conv_quant") != "int8":
        return None
    sites = costs.int8_sites(run.config)
    if run.traced_launches.get("int8_conv") != len(sites) * run.traced_steps:
        return None
    item = ITEMSIZE[run.config["compute_dtype"]]
    one = sum(costs.least_s(costs.int8_conv(run.batch, h, w, cin, cout, item,
                                            ops), costs.PEAK_S8)
              for h, w, cin, cout, ops in sites)
    return run.traced_steps * one


def convres_least_s(run, backward: bool) -> Optional[float]:
    """K2's (or K3's) least time over the traced training steps: per
    micro-batch the full-batch downsample, and the recon rows' down and
    up passes where it has any; None when the launches counted are not
    those."""
    if run.kind != "train" or not run.traced_rows:
        return None
    cfg, item = run.config, ITEMSIZE[run.config["compute_dtype"]]
    c, cm = cfg["d_chans"], cfg["d_chans"] // 2
    down, up = costs.convres_sites(cfg, False), costs.convres_sites(cfg, True)
    total, launches = 0.0, 0
    for rows in run.traced_rows:
        if not backward:
            total += sum(costs.least_s(costs.convres_fwd(
                run.batch, h, w, c, item, s, cm)) for h, w, s in down)
            launches += len(down)
        if rows:
            for h, w, s in down + up:
                cost = (costs.convres_bwd(rows, h, w, c, item, cm) if backward
                        else costs.convres_fwd(rows, h, w, c, item, s, cm))
                total += costs.least_s(cost)
            launches += len(down) + len(up)
    key = "convres_bwd" if backward else "convres_fwd"
    if not launches or run.traced_launches.get(key) != launches:
        return None
    return total


def p95_ms(values) -> Optional[float]:
    if len(values) < 10:
        return None
    return float(np.percentile(np.asarray(values) * 1e3, 95))
