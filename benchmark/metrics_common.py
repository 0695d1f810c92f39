"""Arithmetic that several metric readers share."""

from __future__ import annotations

from .roofline import call_work, least_time
from .trace import busy_s, window_s

KERNEL = "oxc_rollout_kernel"


def window_rate(record):
    """Env-steps per second of the window: B x K x calls over the time
    from the first call's issue to the last call's completion."""
    calls = record["calls"]
    if not calls:
        return None
    span = calls[-1][2] - record["t_start"]
    return record["B"] * record["K"] * len(calls) / span


def idle_pct(record):
    summary = record["trace"]
    if summary is None:
        return None
    win = window_s(summary)
    return 100.0 * (1.0 - busy_s(summary) / win) if win > 0 else None


def traced_least_time(record):
    """(seconds, bound) of the traced calls' work: each traced call's
    work, and B resets for each traced call that reaches the time
    limit."""
    cell, n, b = record["cell"], record["traced_calls"], record["B"]
    one = call_work(cell.config, cell.traffic, b, record["K"], 0)
    resets = call_work(cell.config, cell.traffic, b, 0,
                       b * record["crossing_calls"])
    work = {k: n * v for k, v in one.items()}
    work["lane_ops"] += resets["lane_ops"]
    work["sfu_ops"] += resets["sfu_ops"]
    return least_time(work)
