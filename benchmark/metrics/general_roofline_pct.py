"""general_roofline_pct: the least time of the traced calls' work
(``benchmark/roofline.py``, the same frozen per-env-step counts as the
kernel's) over the device's busy time in the traced window of a
``jit_rollout`` cell, in percent."""

from benchmark.metrics_common import traced_least_time
from benchmark.trace import busy_s


def read(record):
    if record["trace"] is None or record["kind"] != "jit_rollout":
        return None
    busy = busy_s(record["trace"])
    if busy <= 0:
        return None
    least, by = traced_least_time(record)
    return 100.0 * least / busy, f"bound by {by}"
