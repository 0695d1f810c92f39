"""kernel_roofline_pct: the least time of the traced calls' work on this
chip (``benchmark/roofline.py``, from the configuration's frozen counts)
over the rollout kernel's device time, in percent.  The bound that sets
the least time is given beside it."""

from benchmark.metrics_common import KERNEL, traced_least_time
from benchmark.trace import kernels


def read(record):
    if record["trace"] is None or record["kind"] != "fast_rollout":
        return None
    sec, n = kernels(record["trace"], KERNEL)
    if not n:
        return None
    least, by = traced_least_time(record)
    return 100.0 * least / sec, f"bound by {by}"
