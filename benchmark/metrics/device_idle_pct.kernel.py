"""device_idle_pct.kernel: the share of the traced window of a
``fast_rollout`` cell in which no kernel, copy or memset ran on the
device, in percent."""

from benchmark.metrics_common import idle_pct


def read(record):
    if record["kind"] != "fast_rollout":
        return None
    return idle_pct(record)
