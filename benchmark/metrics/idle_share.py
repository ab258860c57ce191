"""Device: % of the untraced window with no kernel running, each of its
steps charged the device time of the traced step of the same work (see
readers.idle_share)."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
