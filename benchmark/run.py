#!/usr/bin/env python3
"""Runs one cell of the benchmark of dddpm_tpu_torch once, on the CUDA
card of this machine:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (building the program, drawing the weights and inputs from the
seed, warming up the cell's shapes) is timed as setup_s, from the
process's start.  Then the window runs for --seconds, the program's
state is freed and the plain reference judges what the window produced.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared beside its limit; the same checks
end standard error.  Without a card, or with fewer than the cell asks
for, it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_START = time.time()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness import spec  # noqa: E402
from benchmark.harness.sample_job import SampleJob  # noqa: E402
from benchmark.harness.train_job import TrainJob  # noqa: E402
from benchmark.reference import compare  # noqa: E402

JOBS = {"sample": SampleJob, "train": TrainJob}
# the port's kernel sources the cells load, built in parallel at set-up
# (into the program's own build directory in the checkout); any other
# builds on its first use
KERNEL_SOURCES = ("attention_block", "convres_fwd", "convres_bwd")
FORBIDDEN = {"jax", "jaxlib", "flax", "dddpm_tpu"}


def process_age() -> float:
    """Seconds since this process started (from /proc; else since this
    module was loaded)."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - started / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _START


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", fault=None) -> dict:
    """One run of the cell; returns the result line as a dict."""
    cuda = torch.device(device).type == "cuda"
    phases = {"interpreter and imports": process_age()}
    if cuda:
        from dddpm_tpu_torch.ops import _build
        _build.build_all(KERNEL_SOURCES)
    phases["kernel builds"] = process_age() - phases["interpreter and imports"]
    job = JOBS[cell.traffic["job"]](cell.config, cell.traffic, seed, device)
    job.setup(fault)
    setup_s = process_age()
    phases.update(job.phases)
    print("setup_s " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()),
          file=sys.stderr)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = job.window(seconds, trace)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    job.release()
    t_check = time.time()
    judged = compare.verdict(job.check()["program"], cell.limits)
    print(f"check_s {time.time() - t_check:.2f}", file=sys.stderr)

    rec = out["record"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        figures = {cell.traffic["rate_metric"]: out["rate"],
                   "peak_mem_gib": peak_window / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": figures[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(peak_setup, peak_window)}
    result = {"correct": judged["correct"], "attempted": out["steps"],
              "failed": judged["failed"], "metrics": metrics, "device": dev}
    if trace:
        top = sorted(((n, e - s) for n, s, e in rec.traced.kernels),
                     key=lambda kv: -kv[1])
        by_name: dict = {}
        for n, d in top:
            by_name[n] = by_name.get(n, 0.0) + d
        for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
            print(f"kernel {d:.6f} s {n[:120]}", file=sys.stderr)
        dev["busy_s"] = rec.traced.busy_s
        dev["window_s"] = rec.traced.window_s
        result["breakdown"] = {
            "device_ops": rec.traced.device_ops(),
            "idle_gaps": [[k, v] for k, v in rec.host_traced.idle_gaps()[:10]]}
    result["checks"] = judged["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
