"""general_launches_per_step: the device kernels of the traced window of
a ``jit_rollout`` cell over its lockstep env steps (traced calls x K)."""

from benchmark.trace import kernels


def read(record):
    if record["trace"] is None or record["kind"] != "jit_rollout":
        return None
    _, n = kernels(record["trace"])
    steps = record["traced_calls"] * record["K"]
    return n / steps if n and steps else None
