"""Process: kernels the device ran a step, over the traced steps."""
from benchmark.harness.readers import launches_per_step as read  # noqa: F401
