"""kernel_ms: the device time of the rollout kernel
(``oxc_rollout_kernel``) in the traced calls, per launch, in
milliseconds."""

from benchmark.metrics_common import KERNEL
from benchmark.trace import kernels


def read(record):
    if record["trace"] is None or record["kind"] != "fast_rollout":
        return None
    sec, n = kernels(record["trace"], KERNEL)
    return 1e3 * sec / n if n else None
