"""general_env_steps_per_s: B x K x the calls completed in the window of a
``jit_rollout`` cell (the general path), over the time from the first
call's issue to the last call's mean return on the host."""

from benchmark.metrics_common import window_rate


def read(record):
    if record["kind"] != "jit_rollout":
        return None
    return window_rate(record)
