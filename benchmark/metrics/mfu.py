"""Device, the whole step: model FLOPs of the untraced window's work over
its time, as a % of the H100's dense bf16 peak (989 TFLOP/s)."""
from benchmark.harness.readers import mfu as read  # noqa: F401
