"""What both jobs share: the clock, the device's peak, the program's
launch counters, and the record the per-layer metrics read."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

now = time.perf_counter


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> Dict[str, int]:
    """The program's launch counters, summed over its kernel modules."""
    from dddpm_tpu_torch.ops import attention_block, convres, quant
    out: Dict[str, int] = {}
    for mod in (attention_block, convres, quant):
        out.update(mod.LAUNCHES)
    return dict(out)


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@dataclass
class Record:
    """One run as the per-layer metrics see it.  The device trace covers
    `traced_steps` steps, the host trace one more; `steps` and `seconds`
    are the measured window after them, which ran untraced; `flops` is
    the model FLOPs of that window (traced runs only).  A step's key
    names its work: `busy_by_key` is the device's busy time of a traced
    step of each key, `window_keys` the key of each untraced step."""
    kind: str
    config: dict
    traffic: dict
    batch: int
    traced: Optional[object] = None
    host_traced: Optional[object] = None
    traced_steps: int = 0
    traced_launches: Dict[str, int] = field(default_factory=dict)
    traced_rows: List[int] = field(default_factory=list)
    steps: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    step_times: List[float] = field(default_factory=list)
    decode_s: Optional[float] = None
    busy_by_key: Dict[int, float] = field(default_factory=dict)
    window_keys: List[int] = field(default_factory=list)
