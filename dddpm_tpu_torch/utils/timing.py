"""Step timing (port of dddpm_tpu/utils/timing.py).

A step's host time means something only if the step ended on the device:
the trainer marks after the metrics of a step are on the device, and
timers used for measurement synchronise the card first."""
from __future__ import annotations

import time
from typing import Dict


class StepTimer:
    """Tracks step wall-times and derived throughput.

    Call mark() once per step; stats() gives mean/min step time and
    items/sec over the recorded window (the first `warmup` intervals
    dropped: they include cuDNN's algorithm search and the kernels'
    builds)."""

    def __init__(self, items_per_step: int = 0, warmup: int = 1):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self._times = []
        self._last = None

    def mark(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def stats(self) -> Dict[str, float]:
        times = self._times[self.warmup:] or self._times
        if not times:
            return {}
        mean = sum(times) / len(times)
        out = {
            "step_time_mean_s": mean,
            "step_time_min_s": min(times),
            "steps_per_sec": 1.0 / mean,
        }
        if self.items_per_step:
            out["items_per_sec"] = self.items_per_step / mean
        return out

