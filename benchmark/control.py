#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the card at the
cell's own size:

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \
        [--controls 3] [--out FILE]

For each seed, one process runs the cell's set-up, a window of
--seconds (by default only as long as the checked steps need) and the
check, and prints the numbers compared for the program; on the first
--controls seeds also for the control (the reference put in the
program's place at the next precision below the configuration's) and,
in training cells, with each planted fault of the reference.  One JSON
line a seed, to standard output and to --out.  The benchmark's own runs
do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness import common, spec  # noqa: E402
from benchmark.run import JOBS, KERNEL_SOURCES  # noqa: E402

# the next precision below each compute type a configuration states
CONTROL = {"bfloat16": "fp8", "int8": "int4"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card; none is present",
              file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    from dddpm_tpu_torch.ops import _build
    _build.build_all(KERNEL_SOURCES)
    prec = CONTROL[cell.config.get("conv_quant") or cell.config["compute_dtype"]]
    out = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(args.seeds):
            job = JOBS[cell.traffic["job"]](cell.config, cell.traffic, seed,
                                            "cuda")
            job.setup()
            job.window(args.seconds, False)
            job.release()
            extra = {}
            if k < args.controls:
                extra["precs"] = (prec,)
                if job.kind == "train":
                    extra["faults"] = ("half_batch",)
            numbers = job.check(**extra)
            if job.kind == "train":
                numbers["worst_leaves"] = job.worst_leaves
            line = json.dumps({"workload": cell.name, "seed": seed, **numbers})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del job
            common.free("cuda")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
