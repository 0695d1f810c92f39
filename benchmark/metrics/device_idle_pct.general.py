"""device_idle_pct.general: the share of the traced window of a
``jit_rollout`` cell in which no kernel, copy or memset ran on the
device, in percent."""

from benchmark.metrics_common import idle_pct


def read(record):
    if record["kind"] != "jit_rollout":
        return None
    return idle_pct(record)
