"""driver_host_ms: the host's time inside the rollout call until it
returns, before the mean return is read, averaged over the window's
calls, in milliseconds (the span ``bench.call``, on the host clock)."""


def read(record):
    calls = record["calls"]
    if record["kind"] != "fast_rollout" or not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in calls) / len(calls)
