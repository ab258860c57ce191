"""The traced windows: torch.profiler over a few steps, reduced to what
the per-layer metrics read.

The device window traces the device alone (CUPTI's kernel records, no
host ops): busy time is the union of the kernels' intervals, and its
length is the host clock from just before the first step is issued to
the synchronize after the last, so host time before the first kernel
and after the last counts as idle (not first kernel to last).  Tracing
still slows a launch-bound step's issue, so the idle share the metrics
report takes each traced step's busy time to the untraced steps of the
same work (`readers.idle_share`); `mark` closes a traced step with a
marker kernel, which splits the trace by step and is not counted.  A
second, shorter window traces the host ops too, only to name what the
host was doing in each idle gap.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Tuple

import torch

WINDOW = "benchmark_window"
# the kernel torch.cuda._sleep launches, the marker between traced steps
MARK = "spin_kernel"

# kernel name fragment -> category, first match wins (copied from
# chip_smoke.py's _category as it stood when the benchmark was defined)
CATEGORIES = (
    ("int8_conv", "Q1 int8_conv"), ("lin_", "K4 linear attention"),
    ("block_1p", "K1c attn_1pass"),
    ("ctx_partial", "K1a attn_ctx"), ("ctx_reduce", "K1a attn_ctx"),
    ("ctx_mma", "K1a attn_ctx"), ("out_mma", "K1b attn_out"),
    ("out_kernel", "K1b attn_out"),
    ("conv3x3_kernel", "K5 conv3x3"), ("winograd_kernel", "K6 winograd"),
    ("convres_general", "K2/K3 general"),
    ("convres_bwd", "K3 convres_bwd"), ("convres", "K2 convres"),
    ("group_norm", "group norm"), ("gemm", "gemm/conv"),
    ("conv", "gemm/conv"), ("xmma", "gemm/conv"), ("cutlass", "gemm/conv"),
    ("nchw", "layout copy"), ("nhwc", "layout copy"), ("copy", "layout copy"),
    ("reduce", "reductions"), ("elementwise", "elementwise"),
    ("vectorized", "elementwise"), ("randn", "rng"), ("philox", "rng"))


def category(name: str) -> str:
    n = name.lower()
    for key, cat in CATEGORIES:
        if key in n:
            return cat
    return "other"


class Traced:
    """Kernels and host ops of one traced window, times in seconds from
    the window's start."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float,
                 marks: Tuple[float, ...] = ()):
        self.kernels, self.host, self.window_s = kernels, host, window_s
        self.marks = sorted(marks)
        spans = sorted((s, e) for _, s, e in kernels)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_spans = merged
        self.busy_s = sum(e - s for s, e in merged)

    def step_busy(self) -> List[float]:
        """Busy seconds before the first mark and between each two
        marks: a step's each, where a mark closes every step."""
        edges = [0.0] + self.marks
        return [sum(max(0.0, min(e, b) - max(s, a)) for s, e in self.busy_spans)
                for a, b in zip(edges, edges[1:])]

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            cat = category(name)
            out[cat] = out.get(cat, 0.0) + (e - s)
        return out

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Seconds of device idle, summed by the host op that was running
        when each gap ended: the latest-started op still open then, else
        the latest to start before it."""
        edges = ([0.0] + [x for s, e in self.busy_spans for x in (s, e)]
                 + [self.window_s])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out: Dict[str, float] = {}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            i = bisect.bisect_right(starts, g1) - 1
            name = host[i][0] if i >= 0 else "before the first host op"
            for j in range(i, max(i - 64, -1), -1):
                if host[j][2] >= g1:
                    name = host[j][0]
                    break
            out[name] = out.get(name, 0.0) + (g1 - g0)
        return sorted(out.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> list:
        """The kernel categories that took most time, [[name, s], ...]."""
        ops = sorted(self.by_category().items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in ops[:10]]


def mark() -> None:
    """A marker kernel on the device, after what was issued before it."""
    torch.cuda._sleep(1)


@contextmanager
def traced(out: list, host: bool = False):
    """Profiles the block, which must synchronize before it ends, and
    appends a Traced of it to `out`; with `host` the host ops too, timed
    from a span of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW) if host else nullcontext():
            yield
        window_s = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != WINDOW]
    kernels = [e for e in device if MARK not in e.name]
    if not kernels:
        raise RuntimeError("the profiler saw no device time")
    if host:
        win = [e for e in events
               if e.name == WINDOW and e.device_type == DeviceType.CPU]
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        window_s = (w1 - w0) * 1e-6
    else:
        w0 = min(e.time_range.start for e in kernels)
        w1 = w0 + window_s * 1e6
    spans = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in kernels]
    ops = [(e.name, e.time_range.start, min(e.time_range.end, w1)) for e in events
           if host and e.device_type == DeviceType.CPU and e.name != WINDOW
           and w0 <= e.time_range.start < w1 and not e.name.startswith("cuda")]
    rel = lambda items: [(n, (a - w0) * 1e-6, (b - w0) * 1e-6)
                         for n, a, b in items if b > a]
    marks = [(e.time_range.start - w0) * 1e-6 for e in device if MARK in e.name]
    out.append(Traced(rel(spans), rel(ops), window_s, tuple(marks)))
